"""MacroKDK — host-stepped KDK over the batched one-sided row sweeps.

The oversized-N driver path: advance is a host loop of per-step dispatch
groups instead of one jitted superstep, and the diagnostics' O(N²)
potential is precomputed outside the jit. These tests run on the jnp
backend and on the Pallas kernels in interpret mode on CPU, and pin (a)
trajectory equivalence with the in-jit LeapfrogKDK, (b) the full driver
loop (run()) with ``integrator.macro_batches`` set, including diagnostics
and snapshot/resume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK, MacroKDK
from oc_nbody_tpu.models.plummer import plummer


# the batched path runs on every backend: the jnp sweep and the Pallas
# (Triton) kernels through the interpreter
BACKENDS = [pytest.param({"backend": "jnp"}, id="jnp"),
            pytest.param({"backend": "jnp", "interpret": True},
                         id="pallas")]


@pytest.mark.parametrize("kw", BACKENDS)
def test_macro_kdk_matches_in_jit_kdk(kw):
    """Same force model, same dt: MacroKDK's host-stepped trajectory must
    track the jitted LeapfrogKDK superstep (different centring and
    dispatch of the f32 pair sums -> f32 tolerance)."""
    n, dt, steps = 300, 1.0 / 64, 5
    state = plummer(n, jax.random.PRNGKey(3))
    force = make_force_model(eps=0.05, **kw)

    ref = LeapfrogKDK(force=force, dt=dt)
    c_ref = ref.init(state)
    c_ref = jax.jit(ref.advance, static_argnums=1)(c_ref, steps)

    mac = MacroKDK(force=force, dt=dt, n_batches=2)
    c_mac = mac.init(state)
    c_mac = mac.advance_to_bounded(c_mac, steps * dt, max_steps=100)

    assert int(c_mac.n_steps) == steps
    assert float(c_mac.state.time) == pytest.approx(steps * dt)
    scale = float(jnp.max(jnp.abs(c_ref.state.pos)))
    err = float(jnp.max(jnp.abs(c_mac.state.pos - c_ref.state.pos)))
    assert err < 1e-5 * scale
    verr = float(jnp.max(jnp.abs(c_mac.state.vel - c_ref.state.vel)))
    assert verr < 1e-5 * float(jnp.max(jnp.abs(c_ref.state.vel)))
    # max_steps bound is respected
    c2 = mac.init(state)
    c2 = mac.advance_to_bounded(c2, steps * dt, max_steps=2)
    assert int(c2.n_steps) == 2


def test_macro_driver_end_to_end(tmp_path):
    """run() with integrator.macro_batches > 0: host-stepped advance,
    precomputed-phi diagnostics, snapshots, and a bit-identical resume
    (the same acceptance criterion as the in-jit driver)."""
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.run import run

    cfg = SimConfig.from_dict({
        "ic": {"kind": "plummer", "n": 192, "seed": 5},
        "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                       "macro_batches": 2},
        "backend": "jnp",
        "output": {"out_dir": str(tmp_path / "macro"),
                   "t_end": 4.0 / 64, "diag_every": 2.0 / 64,
                   "snap_every": 2.0 / 64, "stdout": False},
    })
    res = run(cfg)
    assert res.n_steps == 4
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    # drift over 4 tiny steps should be small and the honest norm present
    assert abs(res.diagnostics["dE_over_E_int"][-1]) < 1e-4
    final_pos = np.asarray(res.state.pos)

    # resume from the mid-run snapshot reproduces the uninterrupted run
    cfg_half = SimConfig.from_dict({
        "ic": {"kind": "plummer", "n": 192, "seed": 5},
        "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                       "macro_batches": 2},
        "backend": "jnp",
        "output": {"out_dir": str(tmp_path / "macro2"),
                   "t_end": 2.0 / 64, "diag_every": 2.0 / 64,
                   "snap_every": 2.0 / 64, "stdout": False},
    })
    run(cfg_half)
    cfg_rest = SimConfig.from_dict({
        "ic": {"kind": "plummer", "n": 192, "seed": 5},
        "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                       "macro_batches": 2},
        "backend": "jnp",
        "output": {"out_dir": str(tmp_path / "macro2"),
                   "t_end": 4.0 / 64, "diag_every": 2.0 / 64,
                   "snap_every": 2.0 / 64, "stdout": False},
    })
    res2 = run(cfg_rest, resume=True)
    np.testing.assert_array_equal(np.asarray(res2.state.pos), final_pos)


def test_macro_snapshot_resumes_in_jit_and_back(tmp_path):
    """Stepper-mode elasticity: a snapshot written by the macro stepper
    resumes under the in-jit LeapfrogKDK and vice versa (same integrator
    kind 'kdk', same aux contract) — an 8M run checkpointed under
    macro_batches can continue on hardware/N where one program fits."""
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.run import run

    def cfg(out, t_end, macro):
        return SimConfig.from_dict({
            "ic": {"kind": "plummer", "n": 192, "seed": 5},
            "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                           "macro_batches": macro},
            "backend": "jnp",
            "output": {"out_dir": out, "t_end": t_end,
                       "diag_every": 2.0 / 64, "snap_every": 2.0 / 64,
                       "stdout": False},
        })

    out = str(tmp_path / "elastic")
    run(cfg(out, 2.0 / 64, macro=2))                      # macro first leg
    res = run(cfg(out, 4.0 / 64, macro=0), resume=True)   # in-jit second
    assert res.n_steps == 4
    out2 = str(tmp_path / "elastic2")
    run(cfg(out2, 2.0 / 64, macro=0))                     # in-jit first leg
    res2 = run(cfg(out2, 4.0 / 64, macro=2), resume=True)  # macro second
    assert res2.n_steps == 4
    # both orders land on the same state as a pure in-jit run (the same
    # row sums of the same f32 operands both ways)
    ref = run(cfg(str(tmp_path / "ref"), 4.0 / 64, macro=0))
    np.testing.assert_array_equal(np.asarray(res.state.pos),
                                  np.asarray(ref.state.pos))
    np.testing.assert_array_equal(np.asarray(res2.state.pos),
                                  np.asarray(ref.state.pos))


@pytest.mark.parametrize("kw", BACKENDS)
def test_macro_extended_tier(kw, tmp_path):
    """precision='extended' through the oversized-eval path: the force
    model routes accel_batched / accel_potential_batched to the extended
    tier's hi/lo row sweeps, and the full macro driver runs the extended
    tier end-to-end (round-3 ROADMAP #5)."""
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.run import run

    # ForceModel-level: extended batched ≡ extended in-jit eval
    n = 300
    state = plummer(n, jax.random.PRNGKey(7))
    force = make_force_model(eps=0.05, precision="extended", **kw)
    a_ref = jax.jit(force.accel)(state.pos, state.mass)
    a_bat = force.accel_batched(state.pos, state.mass, n_batches=2)
    scale = float(jnp.max(jnp.abs(a_ref)))
    assert float(jnp.max(jnp.abs(a_bat - a_ref))) < 5e-6 * scale
    ar, pr, _ = jax.jit(force.accel_potential)(state.pos, state.mass)
    ab, pb, _ = force.accel_potential_batched(state.pos, state.mass,
                                              n_batches=2)
    assert float(jnp.max(jnp.abs(ab - ar))) < 5e-6 * scale
    assert float(jnp.max(jnp.abs(pb - pr))) < 5e-6 * float(
        jnp.max(jnp.abs(pr)))

    # driver-level: extended macro run with diagnostics + resume contract
    cfg = SimConfig.from_dict({
        "ic": {"kind": "plummer", "n": 192, "seed": 5},
        "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                       "macro_batches": 2, "precision": "extended"},
        "backend": "jnp",
        "output": {"out_dir": str(tmp_path / "xmacro"),
                   "t_end": 2.0 / 64, "diag_every": 2.0 / 64,
                   "snap_every": 2.0 / 64, "stdout": False},
    })
    res = run(cfg)
    assert res.n_steps == 2
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    assert abs(res.diagnostics["dE_over_E_int"][-1]) < 1e-4


@pytest.mark.parametrize("kw", BACKENDS)
def test_batched_rejects_df32(kw):
    """The batched API accepts the f32/extended tiers on every backend:
    df32 (no batched form) raises at the first batched call with a clear
    message."""
    state = plummer(64, jax.random.PRNGKey(9))
    force = make_force_model(eps=0.05, precision="df32", **kw)
    with pytest.raises(ValueError, match="batched evals"):
        force.accel_batched(state.pos, state.mass)
    with pytest.raises(ValueError, match="batched evals"):
        force.accel_jerk_batched(state.pos, state.vel, state.mass)


def test_macro_driver_with_time_dependent_field(tmp_path):
    """Host-stepped driver + a configured perturber: the diagnostics'
    precomputed-phi path must bind the evaluation time before calling
    accel_potential_batched (a time-dependent external raises on unbound
    evaluation — round-3 review fix)."""
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.run import run

    cfg = SimConfig.from_dict({
        "units": {"kind": "henon"},
        "ic": {"kind": "plummer", "n": 192, "seed": 5},
        "potential": {"kind": "milky_way",
                      "perturber": {"kind": "plummer",
                                    "mass_msun": 5.0e5, "scale_pc": 15.0,
                                    "x0_pc": [8030.0, -20.0, 0.0],
                                    "v0_kms": [0.0, 280.0, 0.0]}},
        "orbit": {"kind": "circular", "R0_pc": 8000.0},
        "integrator": {"kind": "kdk", "dt": 1.0 / 64, "eps": 0.05,
                       "macro_batches": 2},
        "backend": "jnp",
        "output": {"out_dir": str(tmp_path / "macro_td"),
                   "t_end": 4.0 / 64, "diag_every": 2.0 / 64,
                   "snap_every": 2.0 / 64, "stdout": False},
    })
    res = run(cfg)
    assert res.n_steps == 4
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    assert np.isfinite(res.diagnostics["d_pert"]).all()


@pytest.mark.parametrize("kw", BACKENDS)
def test_macro_yoshida_matches_in_jit(kw):
    """MacroYoshida4's host-stepped trajectory tracks the jitted Yoshida4
    superstep (same contract as the MacroKDK test above)."""
    from oc_nbody_tpu.integrators.leapfrog import MacroYoshida4, Yoshida4

    n, dt, steps = 300, 1.0 / 64, 4
    state = plummer(n, jax.random.PRNGKey(3))
    force = make_force_model(eps=0.05, **kw)

    ref = Yoshida4(force=force, dt=dt)
    c_ref = jax.jit(ref.advance, static_argnums=1)(ref.init(state), steps)

    mac = MacroYoshida4(force=force, dt=dt, n_batches=2)
    c_mac = mac.advance_to_bounded(mac.init(state), steps * dt,
                                   max_steps=100)

    assert int(c_mac.n_steps) == steps
    assert float(c_mac.state.time) == pytest.approx(steps * dt)
    scale = float(jnp.max(jnp.abs(c_ref.state.pos)))
    assert float(jnp.max(jnp.abs(c_mac.state.pos - c_ref.state.pos))) \
        < 1e-5 * scale
    assert float(jnp.max(jnp.abs(c_mac.state.vel - c_ref.state.vel))) \
        < 1e-5 * float(jnp.max(jnp.abs(c_ref.state.vel)))
