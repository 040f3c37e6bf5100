"""Regression tests for the round-1 ADVICE/VERDICT findings (round 2).

Each test pins one previously-latent defect:
  * IMF alpha == 1 divide-by-zero (ADVICE low, imf.py)
  * block restore must reject a changed integer time grid (ADVICE low)
  * diagnostics truncation on resume (ADVICE medium)
  * driver persists the RNG key in snapshots (VERDICT W4)
  * n_diag ceiling: t_end not a multiple of diag_every still simulated
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.io.snapshot import SnapshotWriter, read_snapshot
from oc_nbody_tpu.models.imf import salpeter_imf
from oc_nbody_tpu.run import run


def test_imf_alpha_one_is_finite(key):
    m = salpeter_imf(4096, key, m_min=0.5, m_max=8.0, alpha=1.0)
    m = np.asarray(m)
    assert np.all(np.isfinite(m))
    assert m.min() >= 0.5 and m.max() <= 8.0
    # dN/dm ~ 1/m means log m is uniform: mean(log m) ~ midpoint
    mid = 0.5 * (np.log(0.5) + np.log(8.0))
    assert abs(np.log(m).mean() - mid) < 0.05


def test_imf_alpha_near_one_continuous(key):
    # the p==0 branch must join smoothly with the generic branch
    m1 = np.asarray(salpeter_imf(2048, key, 0.5, 8.0, alpha=1.0))
    m2 = np.asarray(salpeter_imf(2048, key, 0.5, 8.0, alpha=1.0 + 1e-7))
    np.testing.assert_allclose(m1, m2, rtol=1e-4)


def test_block_restore_rejects_grid_change(key):
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.block import BlockHermite
    from oc_nbody_tpu.models.plummer import plummer

    state = plummer(64, key)
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    stepper = BlockHermite(force=force, dt_max=1.0 / 16, n_levels=6)
    carry = stepper.init(state)
    aux = {k: np.asarray(v) for k, v in stepper.checkpoint_aux(carry).items()}

    # same grid: fine
    stepper.restore(state, aux)
    # COARSER grid: integer times would be corrupted — refused
    with pytest.raises(ValueError, match="embed"):
        BlockHermite(force=force, dt_max=1.0 / 8, n_levels=6).restore(state, aux)
    # FINER grid (round-5): embeds exactly — t_i/dt_i rescale by the
    # integer dt_min ratio, physical times and rung lengths preserved
    fine = BlockHermite(force=force, dt_max=1.0 / 16, n_levels=8)
    c2 = fine.restore(state, aux)
    np.testing.assert_array_equal(np.asarray(c2.t_i),
                                  np.asarray(carry.t_i) * 4)
    np.testing.assert_array_equal(
        np.asarray(c2.dt_i, dtype=np.float64) * fine.dt_min,
        np.asarray(carry.dt_i, dtype=np.float64) * stepper.dt_min)
    # halved dt_max, same n_levels: embeds (ratio 2); rungs at the old
    # dt_max clamp to the new one
    half = BlockHermite(force=force, dt_max=1.0 / 32, n_levels=6)
    c3 = half.restore(state, aux)
    np.testing.assert_array_equal(np.asarray(c3.t_i),
                                  np.asarray(carry.t_i) * 2)
    assert np.asarray(c3.dt_i).max() <= half._dt_int_max


def test_truncate_diagnostics(tmp_path):
    w = SnapshotWriter(str(tmp_path), async_io=False)
    for t in (0.0, 0.25, 0.5, 0.75):
        w.append_diagnostics({"time": t, "E_tot": -0.25 - t})
    # resume from t=0.5: rows at 0.5 and 0.75 are stale (re-emitted by the
    # resumed driver)
    w.truncate_diagnostics(0.5)
    d = w.read_diagnostics()
    np.testing.assert_allclose(d["time"], [0.0, 0.25])
    np.testing.assert_allclose(d["E_tot"], [-0.25, -0.5])
    # truncating everything is fine too
    w.truncate_diagnostics(-1.0)
    assert len(w.read_diagnostics()["time"]) == 0


def _tiny_cfg(tmp_path, t_end=0.5, diag_every=0.25):
    cfg = SimConfig()
    cfg.ic.n = 64
    cfg.ic.seed = 3
    cfg.integrator.kind = "kdk"
    cfg.integrator.dt = 1.0 / 64
    cfg.integrator.eps = 1.0 / 32
    cfg.output.out_dir = str(tmp_path)
    cfg.output.t_end = t_end
    cfg.output.diag_every = diag_every
    cfg.output.snap_every = diag_every
    cfg.output.stdout = False
    cfg.backend = "jnp"
    return cfg


def test_resume_truncates_stale_rows(tmp_path):
    cfg = _tiny_cfg(tmp_path / "a", t_end=0.5)
    run(cfg)
    w = SnapshotWriter(cfg.output.out_dir)
    # simulate a crash AFTER the final checkpoint: stale rows beyond t=0.5
    w.append_diagnostics({"time": 0.75, "E_tot": 99.0})
    w.append_diagnostics({"time": 1.0, "E_tot": 99.0})
    cfg.output.t_end = 1.0
    res = run(cfg, resume=True)
    t = res.diagnostics["time"]
    d = w.read_diagnostics()
    # the on-disk series must be strictly monotonic with no stale values
    assert np.all(np.diff(d["time"]) > 0)
    assert not np.any(d["E_tot"] == 99.0)
    assert float(t[-1]) >= 1.0 - 1e-9


def test_snapshot_carries_rng_key(tmp_path):
    cfg = _tiny_cfg(tmp_path, t_end=0.25)
    run(cfg)
    snap = read_snapshot(str(tmp_path / "snapshot_00000.npz"))
    assert "rng_key" in snap.attrs
    key = np.asarray(snap.attrs["rng_key"], np.uint32)
    expect = np.asarray(jax.random.fold_in(jax.random.PRNGKey(3), 0x52554E))
    np.testing.assert_array_equal(key, expect)
    # resume preserves the restored key in subsequent snapshots
    cfg.output.t_end = 0.5
    run(cfg, resume=True)
    snap2 = read_snapshot(str(tmp_path / "snapshot_00001.npz"))
    np.testing.assert_array_equal(
        np.asarray(snap2.attrs["rng_key"], np.uint32), expect)


def test_energies_internal_column(key):
    """E_int = COM-frame KE + pairwise PE. For a COM-at-rest isolated
    cluster it equals E_tot; boosting the frame changes E_tot (KE) but
    leaves E_int invariant."""
    from oc_nbody_tpu.diagnostics import energies
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer

    state = plummer(256, key)
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    e = energies(state, force)
    assert float(e["E_int"]) == pytest.approx(float(e["E_tot"]), rel=1e-10)

    boosted = state.shifted(dvel=jnp.array([50.0, -30.0, 10.0]))
    eb = energies(boosted, force)
    assert float(eb["E_int"]) == pytest.approx(float(e["E_int"]), rel=1e-10)
    assert float(eb["E_tot"]) != pytest.approx(float(e["E_tot"]), rel=1e-3)


def test_energies_f64_pairwise(key):
    """Opt-in f64 diagnostic PE matches the exact direct f64 sum to
    round-off, while the default f32 path carries a visible noise floor."""
    from oc_nbody_tpu.diagnostics import energies
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer
    from oc_nbody_tpu.ops import gravity

    state = plummer(256, key)
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    e64 = energies(state, force, f64_pairwise=True)
    _, phi_exact = gravity.accel_potential_direct(
        state.pos, state.mass, eps=1.0 / 64)
    pe_exact = 0.5 * float(jnp.sum(state.mass * phi_exact))
    assert float(e64["PE_pair"]) == pytest.approx(pe_exact, rel=1e-12)
    e32 = energies(state, force, f64_pairwise=False)
    assert abs(float(e32["PE_pair"]) - pe_exact) >= \
        abs(float(e64["PE_pair"]) - pe_exact)


def test_rung_occupancy(key):
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.block import BlockHermite
    from oc_nbody_tpu.models.plummer import plummer

    state = plummer(128, key)
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    stepper = BlockHermite(force=force, dt_max=1.0 / 16, n_levels=6)
    carry = stepper.init(state)
    occ = np.asarray(stepper.rung_occupancy(carry))
    assert occ.shape == (6,)
    assert occ.sum() == 128
    # cross-check against the raw dt_i values
    dt_i = np.asarray(carry.dt_i)
    for k in range(6):
        assert occ[k] == np.sum(dt_i == (1 << (6 - 1 - k)))


def test_driver_emits_dE_int_and_rungs(tmp_path):
    cfg = _tiny_cfg(tmp_path, t_end=0.25)
    cfg.integrator.kind = "block"
    cfg.integrator.dt_max = 1.0 / 16
    cfg.integrator.n_levels = 6
    res = run(cfg)
    assert "dE_over_E_int" in res.diagnostics
    assert "rung_00" in res.diagnostics and "rung_05" in res.diagnostics
    rungs = np.stack([res.diagnostics[f"rung_{k:02d}"] for k in range(6)])
    np.testing.assert_allclose(rungs.sum(axis=0), 64)  # every row sums to n
    # isolated cluster: E_int == E_tot, so the two drift columns coincide
    np.testing.assert_allclose(res.diagnostics["dE_over_E_int"],
                               res.diagnostics["dE_over_E"], atol=1e-12)


def test_physical_time_cadence(tmp_path):
    """t_end_myr / diag_every_myr override the code-unit fields via the
    scene's unit system (ROADMAP QoL)."""
    from oc_nbody_tpu.scene import build_units
    cfg = _tiny_cfg(tmp_path)
    us = build_units(cfg)
    cfg.output.t_end_myr = 0.25 * us.time_myr       # = 0.25 code units
    cfg.output.diag_every_myr = 0.125 * us.time_myr
    cfg.output.snap_every_myr = 0.25 * us.time_myr
    res = run(cfg)
    assert float(res.state.time) >= 0.25 - 1e-9
    assert float(res.state.time) <= 0.25 + cfg.integrator.dt + 1e-9
    assert len(res.diagnostics["time"]) == 3  # t = 0, 0.125, 0.25


def test_block_split_criterion_external_dominated(key):
    """Rung criterion must not be inflated by a dominant smooth external
    field (c4 failure mode: |a_ext| >> |a_pair| let internal dynamics run
    at dt_max, measured 1e-2 E_int drift per time unit; the split
    pairwise/external criterion measured 3.9e-6 — this test pins the fix
    at small N where the broken version drifts catastrophically)."""
    from oc_nbody_tpu.diagnostics import energies
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.block import BlockHermite
    from oc_nbody_tpu.models.plummer import plummer
    from oc_nbody_tpu.models import potentials as P

    state = plummer(256, key)
    # eccentric-ish orbit around a point mass with |a_ext| >> |a_pair|
    M_gal, R = 1.0e7, 500.0
    pot = P.PointMass(GM=jnp.asarray(float(M_gal)))
    vc = float(pot.vcirc(R))
    state = state.shifted(dpos=jnp.array([R, 0.0, 0.0]),
                          dvel=jnp.array([0.0, 0.8 * vc, 0.3 * vc]))
    force = make_force_model(eps=1.0 / 64, G=1.0, external=pot, backend="jnp")
    a_ext = float(jnp.linalg.norm(pot.accel(jnp.array([R, 0.0, 0.0]))))
    assert a_ext > 5.0  # the regime under test: external dominates

    stepper = BlockHermite(force=force, eta=0.02, eta_init=0.01,
                           dt_max=1.0 / 16, n_levels=8)
    carry = stepper.init(state)
    e0 = float(energies(carry.state, force, f64_pairwise=True)["E_tot"])
    e_int0 = abs(float(energies(carry.state, force,
                                f64_pairwise=True)["E_int"]))
    carry = jax.jit(stepper.advance_to)(carry, 1.0)
    e1 = float(energies(carry.state, force, f64_pairwise=True)["E_tot"])
    drift = abs(e1 - e0) / e_int0
    # broken criterion measured ~1e-2 here; fixed ~1e-6
    assert drift < 1e-4, drift


def test_t_end_not_multiple_of_diag_every(tmp_path):
    # t_end=0.3, diag_every=0.25 used to stop at 0.25 (round -> 1 interval)
    cfg = _tiny_cfg(tmp_path, t_end=0.3, diag_every=0.25)
    res = run(cfg)
    # KDK takes whole steps, so the end time is t_end rounded up by < dt
    assert float(res.state.time) >= 0.3 - 1e-9
    assert float(res.state.time) <= 0.3 + cfg.integrator.dt + 1e-9
