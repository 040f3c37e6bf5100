"""Driver-level stellar-evolution tests: mass loss through run(), the
energy budget (E_tot − E_sev_cum conserved), and bit-exact resume across
death events (idempotent update + deterministic tables)."""
import dataclasses

import numpy as np
import pytest

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.run import run


def _cfg(tmp_path, name, t_end=25.0):
    # top-heavy Salpeter IMF (5–100 Msun) + units chosen so a ~30 Myr run
    # covers the deaths of every star above ~9 Msun: time unit =
    # sqrt(L^3/(G M)) = 1.2 Myr with L = 2 pc, M = 1235 Msun
    cfg = SimConfig.from_dict({
        "units": {"kind": "henon", "mass_msun": 1235.0, "length_pc": 2.0},
        "ic": {"kind": "plummer", "n": 64, "imf": "salpeter",
               "m_min_msun": 5.0, "m_max_msun": 100.0, "seed": 11},
        "sev": {"kind": "simple", "epoch0_myr": 3.0,
                "kick_sigma_ns_kms": 20.0, "kick_sigma_bh_kms": 5.0},
        # eps/dt chosen so the INTEGRATOR drift is tiny (no-SEV baseline
        # measured 1e-5 of E_int): the budget test below must see the
        # stellar-evolution jumps, not KDK error from hard encounters
        "integrator": {"kind": "kdk", "dt": 1.0 / 256, "eps": 0.125},
        "output": {"out_dir": str(tmp_path / name), "t_end": t_end,
                   "diag_every": 0.5, "snap_every": 2.5, "stdout": False},
    })
    cfg.backend = "jnp"
    return cfg


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sev_run")
    res = run(_cfg(tmp, "full"))
    return tmp, res


def test_mass_loss_and_remnants(full_run):
    _, res = full_run
    d = res.diagnostics
    # stellar evolution columns exist and move the right way
    assert d["M_tot"][0] > d["M_tot"][-1], "total mass must decrease"
    assert d["N_rem"][-1] > d["N_rem"][0] >= 0
    assert np.all(np.diff(d["N_rem"]) >= 0), "death count is monotone"
    assert np.all(np.diff(d["M_tot"]) <= 1e-7), "mass never increases"
    assert d["dM_sev"][-1] > 0.05, "a top-heavy IMF must shed >5% mass"
    np.testing.assert_allclose(
        d["M_tot"][-1] + d["dM_sev"][-1], d["M_tot"][0] + d["dM_sev"][0],
        rtol=1e-6)


def test_energy_budget_closes(full_run):
    _, res = full_run
    d = res.diagnostics
    # the raw drift is dominated by the accounted stellar-evolution jumps…
    assert abs(d["E_sev_cum"][-1]) > 0.0
    # …and the corrected budget E_tot − E_sev_cum drifts only at the
    # integrator level: orders of magnitude below the accounted jumps
    cons = np.abs(d["dE_cons_over_E_int"][-1])
    raw = np.abs(d["dE_over_E_int"][-1])
    assert cons < 2e-3, f"conservation residual too large: {cons}"
    assert cons < 0.05 * max(raw, 1e-12), (
        f"budget does not close: residual {cons} vs raw drift {raw}")


def test_resume_is_bit_exact_across_deaths(full_run, tmp_path):
    tmp, res_full = full_run
    # leg 1: stop halfway (snapshot lands exactly at t = 12.5)
    run(_cfg(tmp_path, "legs", t_end=12.5))
    # leg 2: resume to the full length
    res_b = run(_cfg(tmp_path, "legs", t_end=25.0), resume=True)

    np.testing.assert_array_equal(np.asarray(res_full.state.mass),
                                  np.asarray(res_b.state.mass))
    np.testing.assert_array_equal(np.asarray(res_full.state.pos),
                                  np.asarray(res_b.state.pos))
    np.testing.assert_array_equal(np.asarray(res_full.state.vel),
                                  np.asarray(res_b.state.vel))
    # the energy bookkeeping continues across the resume
    np.testing.assert_allclose(res_b.diagnostics["E_sev_cum"][-1],
                               res_full.diagnostics["E_sev_cum"][-1],
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("integ", [
    {"kind": "hermite", "eta": 0.02, "eps": 0.125, "dt_max": 1.0 / 16},
    {"kind": "block", "eta": 0.02, "eps": 0.125, "dt_max": 1.0 / 16,
     "n_levels": 6},
])
def test_budget_and_resume_other_integrators(tmp_path, integ):
    """The SEV update rebuilds the integrator carry out-of-band
    (the driver's _reinit): acc/jerk/rung assignments are stale once masses
    change, so hermite/block must re-init and still (a) close the energy
    budget and (b) resume bit-exactly across death events."""
    def cfg(name, t_end):
        c = _cfg(tmp_path, name, t_end=t_end)
        return dataclasses.replace(
            c, integrator=dataclasses.replace(c.integrator, **integ))

    res_full = run(cfg(f"{integ['kind']}_full", 10.0))
    d = res_full.diagnostics
    assert d["N_rem"][-1] > d["N_rem"][0]
    assert abs(d["dE_cons_over_E_int"][-1]) < 2e-3, (
        f"{integ['kind']}: budget residual {d['dE_cons_over_E_int'][-1]}")

    run(cfg(f"{integ['kind']}_legs", 5.0))
    res_b = run(cfg(f"{integ['kind']}_legs", 10.0), resume=True)
    np.testing.assert_array_equal(np.asarray(res_full.state.mass),
                                  np.asarray(res_b.state.mass))
    np.testing.assert_array_equal(np.asarray(res_full.state.pos),
                                  np.asarray(res_b.state.pos))
    np.testing.assert_array_equal(np.asarray(res_full.state.vel),
                                  np.asarray(res_b.state.vel))
    np.testing.assert_allclose(res_b.diagnostics["E_sev_cum"][-1],
                               res_full.diagnostics["E_sev_cum"][-1],
                               rtol=1e-10, atol=1e-14)


def test_macro_stepper_with_sev(tmp_path):
    """[sev] through the multi-dispatch macro path (host-stepped KDK with
    integrator.macro_batches): the SEV boundary runs compute_diag via the
    batched evals and rebuilds the macro carry with stepper.init. The
    death schedule (masses, N_rem) must match the in-jit jnp run exactly
    — it is deterministic from the config — and the energy ledger to the
    f32 pair-summation-order tolerance."""
    def base(name, macro):
        c = _cfg(tmp_path, name, t_end=4.0)
        c.backend = "jnp"
        integ = dataclasses.replace(c.integrator, dt=1.0 / 8,
                                    macro_batches=2 if macro else 0)
        out = dataclasses.replace(c.output, diag_every=1.0, snap_every=2.0)
        return dataclasses.replace(c, integrator=integ, output=out)

    res_m = run(base("macro", True))
    res_j = run(base("injit", False))
    assert res_m.diagnostics["N_rem"][-1] > res_m.diagnostics["N_rem"][0], \
        "no deaths inside the run — test is vacuous"
    np.testing.assert_array_equal(np.asarray(res_m.diagnostics["N_rem"]),
                                  np.asarray(res_j.diagnostics["N_rem"]))
    np.testing.assert_array_equal(np.asarray(res_m.state.mass),
                                  np.asarray(res_j.state.mass))
    np.testing.assert_allclose(res_m.diagnostics["E_sev_cum"][-1],
                               res_j.diagnostics["E_sev_cum"][-1], rtol=5e-3)


def test_wind_mass_loss_budget_and_resume(tmp_path):
    """wind_fraction=0.5: mass leaves gradually (many boundaries with a
    strict M_tot decrease, not a few jumps), the energy ledger still
    closes, and resume across wind erosion stays bit-exact."""
    def cfg(name, t_end):
        c = _cfg(tmp_path, name, t_end=t_end)
        return dataclasses.replace(c, sev=dataclasses.replace(
            c.sev, wind_fraction=0.5, wind_time_frac=0.5))

    res = run(cfg("winds", 15.0))
    d = res.diagnostics
    assert d["N_rem"][-1] > 0
    dm = np.diff(d["M_tot"])
    assert np.all(dm <= 1e-12), "mass never increases"
    assert (dm < -1e-9).sum() >= 10, (
        "winds should erode mass at most boundaries, got "
        f"{(dm < -1e-9).sum()} decreasing intervals")
    assert abs(d["dE_cons_over_E_int"][-1]) < 2e-3

    run(cfg("wind_legs", 7.5))
    res_b = run(cfg("wind_legs", 15.0), resume=True)
    np.testing.assert_array_equal(np.asarray(res.state.mass),
                                  np.asarray(res_b.state.mass))
    np.testing.assert_array_equal(np.asarray(res.state.pos),
                                  np.asarray(res_b.state.pos))
    np.testing.assert_allclose(res_b.diagnostics["E_sev_cum"][-1],
                               res.diagnostics["E_sev_cum"][-1],
                               rtol=1e-10, atol=1e-14)


def test_kicks_change_velocities(tmp_path):
    # same seed, kicks on vs off: remnant velocities must differ
    cfg_off = _cfg(tmp_path, "nokick", t_end=10.0)
    cfg_off = dataclasses.replace(
        cfg_off, sev=dataclasses.replace(cfg_off.sev, kick_sigma_ns_kms=0.0,
                                         kick_sigma_bh_kms=0.0))
    cfg_on = _cfg(tmp_path, "kick", t_end=10.0)
    res_off = run(cfg_off)
    res_on = run(cfg_on)
    # deaths happened in both (same tables), but only one run was kicked
    assert res_on.diagnostics["N_rem"][-1] == res_off.diagnostics["N_rem"][-1]
    assert res_on.diagnostics["N_rem"][-1] > 0
    assert not np.allclose(np.asarray(res_on.state.vel),
                           np.asarray(res_off.state.vel))
    # both budgets still close
    assert abs(res_on.diagnostics["dE_cons_over_E_int"][-1]) < 2e-3
