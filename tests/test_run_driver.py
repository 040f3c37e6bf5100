"""End-to-end run() driver on CPU: outputs, resume, NaN guard
(SURVEY.md §3.1, §5)."""
import os

import numpy as np
import pytest

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.run import run


def _tiny_cfg(tmp_path, **kw):
    cfg = SimConfig()
    cfg.ic.n = 48
    cfg.ic.seed = 7
    cfg.integrator.dt = 1.0 / 128
    cfg.integrator.eps = 1.0 / 16
    cfg.output.out_dir = str(tmp_path / "run")
    cfg.output.t_end = 0.5
    cfg.output.diag_every = 0.25
    cfg.output.snap_every = 0.25
    cfg.output.stdout = False
    cfg.backend = "jnp"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_run_produces_outputs(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    res = run(cfg)
    assert res.n_steps == 64
    assert float(res.state.time) == pytest.approx(0.5)
    files = sorted(os.listdir(cfg.output.out_dir))
    assert "diagnostics.npz" in files
    assert any(f.startswith("snapshot_") for f in files)
    assert "E_tot" in res.diagnostics and len(res.diagnostics["E_tot"]) == 3
    assert abs(res.diagnostics["dE_over_E"][-1]) < 1e-5
    assert np.isfinite(res.wall_per_myr)


def test_run_resume_continues(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    run(cfg)
    cfg2 = _tiny_cfg(tmp_path)
    cfg2.output.t_end = 1.0
    res2 = run(cfg2, resume=True)
    assert float(res2.state.time) == pytest.approx(1.0)
    assert res2.n_steps == 128  # counter restored, not reset
    # dE/E baseline is the ORIGINAL first row, not the resume point
    d = res2.diagnostics
    assert len(d["E_tot"]) >= 3


def test_fresh_run_resets_stale_outputs(tmp_path):
    """A fresh (non-resume) run into an existing out_dir must not append
    diagnostics after the old rows (duplicated times) nor leave stale
    higher-index snapshots that a later --resume would pick up."""
    cfg = _tiny_cfg(tmp_path)
    cfg.output.t_end = 1.0
    run(cfg)
    snaps1 = sorted(f for f in os.listdir(cfg.output.out_dir)
                    if f.startswith("snapshot_"))
    cfg2 = _tiny_cfg(tmp_path)  # shorter fresh run, same out_dir
    res2 = run(cfg2)
    t = res2.diagnostics["time"]
    assert np.all(np.diff(t) > 0), f"non-monotonic diagnostics times: {t}"
    snaps = sorted(f for f in os.listdir(cfg.output.out_dir)
                   if f.startswith("snapshot_"))
    # only the fresh (shorter) run's snapshots remain — the long run's
    # higher indices are gone
    assert len(snaps) < len(snaps1), (snaps, snaps1)
    assert snaps == snaps1[:len(snaps)]


def test_run_hermite_kind(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.kind = "hermite"
    cfg.integrator.eta = 0.02
    res = run(cfg)
    assert float(res.state.time) == pytest.approx(0.5)


def test_resume_integrator_mismatch_raises(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    run(cfg)
    cfg2 = _tiny_cfg(tmp_path)
    cfg2.integrator.kind = "hermite"
    with pytest.raises(ValueError, match="integrator"):
        run(cfg2, resume=True)


def test_run_precision_tiers(tmp_path):
    """The extended/df32 pairwise tiers drive end-to-end and conserve
    energy at least as well as f32 (SURVEY.md §7 hard part #1)."""
    drifts = {}
    for prec in ("f32", "extended", "df32"):
        cfg = _tiny_cfg(tmp_path)
        cfg.output.out_dir = str(tmp_path / f"run_{prec}")
        cfg.integrator.precision = prec
        res = run(cfg)
        drifts[prec] = abs(res.diagnostics["dE_over_E"][-1])
    assert drifts["df32"] < 1e-5
    # at n=48 the drift is dt-limited, so just require same order
    assert drifts["extended"] < 10 * max(drifts["f32"], 1e-12)


def test_run_precision_mesh(tmp_path):
    """Round 3: the extended tier RUNS on a mesh (round-2 Missing #1
    closed); df32 is still rejected with the routing rationale."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs >1 device")
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.precision = "extended"
    cfg.mesh.n_devices = 2
    res = run(cfg)
    assert float(res.state.time) == pytest.approx(0.5)
    cfg2 = _tiny_cfg(tmp_path / "df32")
    cfg2.integrator.precision = "df32"
    cfg2.mesh.n_devices = 2
    with pytest.raises(ValueError, match="single-chip"):
        run(cfg2)


def test_run_block_kind(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.kind = "block"
    cfg.integrator.dt_max = 1.0 / 16
    cfg.integrator.n_levels = 4
    res = run(cfg)
    assert float(res.state.time) == pytest.approx(0.5)


def test_run_with_gmc_perturber(tmp_path):
    """CLI-shaped run with a [potential.perturber]: the moving field is
    advanced inside the jitted loop (force.at_time) and the run completes
    with finite diagnostics (configs/gmc_flyby_8k.toml at toy scale)."""
    cfg = _tiny_cfg(tmp_path)
    cfg.potential.kind = "milky_way"
    cfg.orbit.kind = "circular"
    cfg.orbit.R0_pc = 8000.0
    cfg.potential.perturber.kind = "plummer"
    cfg.potential.perturber.mass_msun = 5.0e5
    cfg.potential.perturber.scale_pc = 15.0
    cfg.potential.perturber.x0_pc = (8030.0, -20.0, 0.0)
    cfg.potential.perturber.v0_kms = (0.0, 280.0, 0.0)
    res = run(cfg)
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    # d_pert column: the closing perturber's separation shrinks
    dp = res.diagnostics["d_pert"]
    assert np.isfinite(dp).all() and dp[-1] < dp[0]
    # the perturber really acts: rerun without it gives different state
    cfg2 = _tiny_cfg(tmp_path)
    cfg2.output.out_dir = str(tmp_path / "run2")
    cfg2.potential.kind = "milky_way"
    cfg2.orbit.kind = "circular"
    cfg2.orbit.R0_pc = 8000.0
    res2 = run(cfg2)
    assert not np.allclose(np.asarray(res.state.pos),
                           np.asarray(res2.state.pos))


def test_run_with_rotating_bar(tmp_path):
    """CLI-shaped run with a ramped rotating bar: Jacobi integral in the
    bar frame is the conserved check once the ramp ends (configs/
    bar_cluster_8k.toml at toy scale)."""
    cfg = _tiny_cfg(tmp_path)
    cfg.potential.kind = "milky_way"
    cfg.orbit.kind = "circular"
    cfg.orbit.R0_pc = 4000.0
    cfg.potential.bar.kind = "long_murali"
    cfg.potential.bar.grow_myr = 0.0   # bar on from t=0 → E_J conserved
    res = run(cfg)
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    # the driver emits the Jacobi columns itself, and E_J is conserved
    ej = res.diagnostics["E_J"]
    assert np.isfinite(ej).all()
    assert abs(res.diagnostics["dEJ_over_EJ"][-1]) < 5e-4
    # ... and it matches diagnostics.jacobi_energy recomputed post-hoc
    from oc_nbody_tpu.diagnostics import jacobi_energy
    from oc_nbody_tpu.scene import build_scene
    from oc_nbody_tpu.utils.units import KMS_IN_PC_PER_MYR
    scene = build_scene(cfg)
    om_code = (cfg.potential.bar.pattern_speed_kms_kpc
               * KMS_IN_PC_PER_MYR / 1000.0 * scene.units.time_myr)
    ej1 = float(jacobi_energy(res.state, scene.force, om_code))
    assert ej1 == pytest.approx(ej[-1], rel=1e-9)


def test_run_hermite_with_perturber(tmp_path):
    """Hermite + configured perturber end-to-end: this is the path whose
    external jerk silently dropped da_ext/dt before the Composite
    accel_jerk_ext fix (round-3 review) — pin that it runs and that the
    adaptive stepper stays healthy alongside the moving field."""
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.kind = "hermite"
    cfg.integrator.eta = 0.02
    cfg.potential.kind = "milky_way"
    cfg.orbit.kind = "circular"
    cfg.orbit.R0_pc = 8000.0
    cfg.potential.perturber.kind = "plummer"
    cfg.potential.perturber.mass_msun = 5.0e5
    cfg.potential.perturber.scale_pc = 15.0
    cfg.potential.perturber.x0_pc = (8030.0, -20.0, 0.0)
    cfg.potential.perturber.v0_kms = (0.0, 280.0, 0.0)
    res = run(cfg)
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    assert np.isfinite(res.diagnostics["d_pert"]).all()


def test_run_yoshida4_and_resume(tmp_path):
    """kind='yoshida4' end-to-end: dt^4-class drift at a coarse dt, plus
    bitwise resume through the standard snapshot contract."""
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.kind = "yoshida4"
    cfg.integrator.dt = 1.0 / 64          # coarse: KDK would drift ~1e-5
    cfg.output.t_end = 1.0
    cfg.output.diag_every = 0.5
    cfg.output.snap_every = 0.5
    res = run(cfg)
    assert res.n_steps == 64
    assert abs(res.diagnostics["dE_over_E"][-1]) < 1e-6  # f32 force-noise floor

    # uninterrupted reference to t=2
    cfg_full = _tiny_cfg(tmp_path, **{})
    cfg_full.integrator.kind = "yoshida4"
    cfg_full.integrator.dt = 1.0 / 64
    cfg_full.output.out_dir = str(tmp_path / "full")
    cfg_full.output.t_end = 2.0
    cfg_full.output.diag_every = 0.5
    cfg_full.output.snap_every = 0.5
    res_full = run(cfg_full)

    cfg2 = _tiny_cfg(tmp_path)
    cfg2.integrator.kind = "yoshida4"
    cfg2.integrator.dt = 1.0 / 64
    cfg2.output.t_end = 2.0
    cfg2.output.diag_every = 0.5
    cfg2.output.snap_every = 0.5
    res2 = run(cfg2, resume=True)
    assert res2.n_steps == 128
    np.testing.assert_array_equal(np.asarray(res2.state.pos),
                                  np.asarray(res_full.state.pos))
    np.testing.assert_array_equal(np.asarray(res2.state.vel),
                                  np.asarray(res_full.state.vel))


def test_yoshida_kdk_resume_mismatch_refused(tmp_path):
    """A yoshida4 snapshot must not silently resume under kind='kdk'
    (same aux shape — only the kind string distinguishes them)."""
    cfg = _tiny_cfg(tmp_path)
    cfg.integrator.kind = "yoshida4"
    run(cfg)
    cfg2 = _tiny_cfg(tmp_path)
    cfg2.integrator.kind = "kdk"
    cfg2.output.t_end = 1.0
    with pytest.raises(ValueError, match="integrator"):
        run(cfg2, resume=True)
