"""Chandrasekhar dynamical friction (models/friction.py).

Oracles: hand-written numpy for the drag formula; analytic Laplacians for
the density-from-potential route; and the textbook inspiral in a (nearly)
singular isothermal sphere — for a flat rotation curve with σ = v0/√2 the
orbit obeys r·dr/dt = −F(1)·lnΛ·G·M/v0 with F(1) = erf(1) − 2e⁻¹/√π =
0.4276 (Binney & Tremaine eq. 8.26 class of result), i.e. r² decays
linearly at rate 2·F(1)·lnΛ·G·M/v0.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.special import erf

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.models import potentials as pot
from oc_nbody_tpu.models.friction import ChandrasekharFriction
from oc_nbody_tpu.run import run


def test_laplacian_matches_analytic():
    """density-from-potential: ∇²Φ via the autodiff Hessian trace vs the
    closed forms for LogHalo and PlummerSphere."""
    v0, rc = 1.7, 0.3
    halo = pot.LogHalo(v0=jnp.asarray(v0), rc=jnp.asarray(rc))
    for r in (0.5, 2.0, 11.0):
        x = jnp.asarray([r, 0.0, 0.0])
        lap = float(halo.laplacian(x))
        expect = v0**2 * (3 * rc**2 + r**2) / (rc**2 + r**2) ** 2
        assert lap == pytest.approx(expect, rel=1e-9)

    GM, b = 2.3, 0.9
    pl = pot.PlummerSphere(GM=jnp.asarray(GM), b=jnp.asarray(b))
    for r in (0.2, 1.0, 4.0):
        x = jnp.asarray([0.0, r, 0.0])
        rho_g = float(pl.density(x, G=1.0))          # G·ρ with G baked in GM
        expect = 3 * GM / (4 * np.pi * b**3) * (1 + (r / b) ** 2) ** -2.5
        assert rho_g == pytest.approx(expect, rel=1e-9)


def test_drag_formula_matches_numpy():
    """accel_df vs the hand-evaluated Chandrasekhar formula for a tiny
    state with a known CoM."""
    v0, rc, lnl, G = 1.5, 0.01, 7.0, 1.0
    halo = pot.LogHalo(v0=jnp.asarray(v0), rc=jnp.asarray(rc))
    fr = ChandrasekharFriction(host=halo, G=jnp.asarray(G),
                               ln_lambda=jnp.asarray(lnl),
                               sigma=jnp.asarray(0.0))
    pos = jnp.asarray([[4.0, 0.0, 0.0], [4.2, 0.0, 0.0]])
    vel = jnp.asarray([[0.0, 1.2, 0.0], [0.0, 1.0, 0.0]])
    mass = jnp.asarray([2.0, 1.0])
    a = np.asarray(fr.accel_df(pos, vel, mass))

    m = np.asarray(mass, np.float64)
    com = (np.asarray(pos) * m[:, None]).sum(0) / m.sum()
    vcom = (np.asarray(vel) * m[:, None]).sum(0) / m.sum()
    r = np.linalg.norm(com)
    v = np.linalg.norm(vcom)
    lap = v0**2 * (3 * rc**2 + r**2) / (rc**2 + r**2) ** 2
    vc = v0 * r / np.sqrt(rc**2 + r**2)
    sigma = vc / np.sqrt(2)
    x = v / (np.sqrt(2) * sigma)
    fx = erf(x) - 2 * x * np.exp(-x * x) / np.sqrt(np.pi)
    expect = -G * lap * m.sum() * lnl * fx / v**3 * vcom
    np.testing.assert_allclose(a, expect, rtol=1e-7)
    # the drag opposes the CoM motion
    assert float(np.dot(a, vcom)) < 0


def test_force_model_requires_vel():
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer
    halo = pot.LogHalo(v0=jnp.asarray(1.0), rc=jnp.asarray(0.1))
    fr = ChandrasekharFriction(host=halo, G=jnp.asarray(1.0),
                               ln_lambda=jnp.asarray(5.0),
                               sigma=jnp.asarray(0.0))
    fm = make_force_model(eps=1 / 64, external=halo, backend="jnp",
                          friction=fr)
    s = plummer(32, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="vel"):
        fm.accel(s.pos, s.mass)
    a = fm.accel(s.pos, s.mass, vel=s.vel)
    assert a.shape == s.pos.shape and bool(jnp.all(jnp.isfinite(a)))


def _inspiral_cfg(out_dir, ln_lambda, t_end):
    cfg = SimConfig.from_dict({
        # time unit 0.471 Myr, velocity unit 2.076 km/s (L=1 pc, M=1000)
        "units": {"kind": "henon", "mass_msun": 1000.0, "length_pc": 1.0},
        "ic": {"kind": "plummer", "n": 64, "seed": 7},
        # near-singular isothermal sphere: flat v_c, σ = v0/√2, X = 1
        "potential": {"kind": "log_halo", "v0_kms": 20.451,  # 9.85 code
                      "rc_pc": 0.01},
        # R0 chosen so r_t = (G M r²/(2 v0²))^{1/3} ≈ 3.8 ≈ 5 r_half:
        # the cluster must SURVIVE (a 50 pc orbit measured 74% stripped —
        # debris pollutes the CoM and the drag overshoots 2x)
        "orbit": {"kind": "circular", "R0_pc": 105.0},
        "friction": {"kind": "chandrasekhar", "ln_lambda": ln_lambda},
        "integrator": {"kind": "kdk", "dt": 1.0 / 128, "eps": 1.0 / 32},
        "output": {"out_dir": str(out_dir), "t_end": t_end,
                   "diag_every": 8.0, "snap_every": 64.0, "stdout": False},
    })
    cfg.backend = "jnp"
    return cfg


def test_isothermal_inspiral_rate(tmp_path):
    """The classic validation: orbital decay in a (nearly) singular
    isothermal halo matches d(r²)/dt = −2·F(1)·lnΛ·G·M/v0.

    Test design matters here (both failure modes were measured):
    * the body must be a COMPACT NON-RELAXING pair (n=2) — a live n=64
      cluster evaporates (t_rh ≈ 3 t.u.) and its debris pollutes the
      CoM/drag, overshooting the decay ~2×;
    * the window must span ≳3 orbital periods — the secular decay only
      emerges after epicyclic averaging (a 16-t.u. window UNDERSHOT 2×).
    With both respected the measured slope matches to 0.09%."""
    import dataclasses
    import glob

    from oc_nbody_tpu.io.snapshot import read_snapshot

    lnl, t_end = 20.0, 200.0
    cfg = _inspiral_cfg(tmp_path / "inspiral", lnl, t_end)
    cfg = dataclasses.replace(
        cfg, ic=dataclasses.replace(cfg.ic, n=2),
        output=dataclasses.replace(cfg.output, diag_every=5.0,
                                   snap_every=10.0))
    res = run(cfg)
    assert "a_df" in res.diagnostics
    assert np.all(res.diagnostics["a_df"][1:] > 0)

    ts, r2s = [], []
    for p in sorted(glob.glob(str(tmp_path / "inspiral" / "snapshot_*.npz"))):
        s = read_snapshot(p).state
        m = np.asarray(s.mass, np.float64)
        com = (np.asarray(s.pos) * m[:, None]).sum(0) / m.sum()
        ts.append(float(s.time))
        r2s.append(float((com ** 2).sum()))
    slope = np.polyfit(np.asarray(ts), np.asarray(r2s), 1)[0]
    v0 = 20.451 / 2.0739       # code units (velocity_kms for these units)
    f1 = erf(1.0) - 2.0 * np.exp(-1.0) / np.sqrt(np.pi)
    expect = -2.0 * f1 * lnl * 1.0 * 1.0 / v0   # G=1, M_cl=1 (Hénon)
    assert slope == pytest.approx(expect, rel=0.02), (slope, expect)


def test_friction_validation(tmp_path):
    import dataclasses
    cfg = _inspiral_cfg(tmp_path / "bad", 1.0, 1.0)
    bad = dataclasses.replace(
        cfg, friction=dataclasses.replace(cfg.friction, ln_lambda=0.0))
    with pytest.raises(ValueError, match="ln_lambda"):
        run(bad)
    # round-4: friction x block is WIRED (test_isothermal_inspiral_rate_
    # block below) and friction x mesh composes too — the sharded driver
    # equality is pinned in tests/distributed/test_sharded_friction.py,
    # so no mesh refusal remains to pin here
    bad3 = dataclasses.replace(
        cfg, potential=dataclasses.replace(cfg.potential, kind="none"),
        orbit=dataclasses.replace(cfg.orbit, kind="none"))
    with pytest.raises(ValueError, match="external"):
        run(bad3)


# --------------------------------------------------------------------------
# round-4: friction x block and friction x macro (VERDICT round-3 item 5)
# --------------------------------------------------------------------------

def test_isothermal_inspiral_rate_block(tmp_path):
    """The SIS decay law through the BLOCK integrator: the drag now rides
    the active-row evaluations (ForceModel.accel_jerk_on_rows), so the
    inspiral works with block timesteps — the composition the round-3
    refusal made impossible. Same oracle and design constraints as the
    kdk test above (n=2 compact pair, >=3 orbital periods)."""
    import dataclasses
    import glob

    from oc_nbody_tpu.io.snapshot import read_snapshot

    lnl, t_end = 20.0, 200.0
    cfg = _inspiral_cfg(tmp_path / "blk", lnl, t_end)
    cfg = dataclasses.replace(
        cfg,
        ic=dataclasses.replace(cfg.ic, n=2),
        integrator=dataclasses.replace(
            cfg.integrator, kind="block", eta=0.02, dt_max=1.0 / 16,
            n_levels=6),
        output=dataclasses.replace(cfg.output, diag_every=5.0,
                                   snap_every=10.0))
    res = run(cfg)
    assert "a_df" in res.diagnostics
    assert np.all(res.diagnostics["a_df"][1:] > 0)

    ts, r2s = [], []
    for p in sorted(glob.glob(str(tmp_path / "blk" / "snapshot_*.npz"))):
        s = read_snapshot(p).state
        m = np.asarray(s.mass, np.float64)
        com = (np.asarray(s.pos) * m[:, None]).sum(0) / m.sum()
        ts.append(float(s.time))
        r2s.append(float((com ** 2).sum()))
    slope = np.polyfit(np.asarray(ts), np.asarray(r2s), 1)[0]
    v0 = 20.451 / 2.0739
    f1 = erf(1.0) - 2.0 * np.exp(-1.0) / np.sqrt(np.pi)
    expect = -2.0 * f1 * lnl * 1.0 * 1.0 / v0
    assert slope == pytest.approx(expect, rel=0.02), (slope, expect)


@pytest.mark.parametrize("kw", [
    pytest.param({"backend": "jnp"}, id="jnp"),
    pytest.param({"backend": "pallas", "interpret": True}, id="pallas")])
def test_macro_friction_matches_in_jit(tmp_path, kw):
    """friction x macro_batches: the drag flows through accel_batched
    (kick-point velocities threaded by the macro steppers), so the
    host-stepped trajectory tracks the in-jit KDK with friction."""
    import dataclasses

    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK, MacroKDK
    from oc_nbody_tpu.models.plummer import plummer

    halo = pot.LogHalo(v0=jnp.asarray(5.0), rc=jnp.asarray(0.05))
    fr = ChandrasekharFriction(host=halo, G=jnp.asarray(1.0),
                               ln_lambda=jnp.asarray(10.0),
                               sigma=jnp.asarray(0.0))
    force = make_force_model(eps=0.05, external=halo, friction=fr, **kw)
    n, dt, steps = 128, 1.0 / 64, 4
    state = plummer(n, jax.random.PRNGKey(3)).shifted(
        dpos=jnp.array([30.0, 0.0, 0.0]),
        dvel=jnp.array([0.0, 5.0, 0.0]))

    ref = LeapfrogKDK(force=force, dt=dt)
    c_ref = jax.jit(ref.advance, static_argnums=1)(ref.init(state), steps)
    mac = MacroKDK(force=force, dt=dt, n_batches=2)
    c_mac = mac.advance_to_bounded(mac.init(state), steps * dt,
                                   max_steps=100)
    # the drag is large enough to matter: switching it off must move
    # trajectory far more than the macro-vs-in-jit difference
    scale = float(jnp.max(jnp.abs(c_ref.state.pos)))
    err = float(jnp.max(jnp.abs(c_mac.state.pos - c_ref.state.pos)))
    assert err < 1e-5 * scale
    nof = LeapfrogKDK(force=dataclasses.replace(force, friction=None),
                      dt=dt)
    c_nof = jax.jit(nof.advance, static_argnums=1)(nof.init(state), steps)
    gap = float(jnp.max(jnp.abs(c_nof.state.pos - c_ref.state.pos)))
    assert gap > 100 * max(err, 1e-12), (gap, err)
