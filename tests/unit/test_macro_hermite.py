"""MacroHermite — host-stepped shared-dt Hermite over the batched
one-sided jerk sweeps (the Hermite twin of MacroKDK; round-3 ROADMAP
#5's second half). Pins (a) trajectory equivalence with the in-jit
Hermite4, (b) the full driver loop with kind="hermite" +
``integrator.macro_batches``, (c) macro <-> in-jit snapshot elasticity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.hermite import Hermite4, MacroHermite
from oc_nbody_tpu.models.plummer import plummer


# the batched path runs on every backend: the jnp sweep and the Pallas
# (Triton) kernels through the interpreter
BACKENDS = [pytest.param({"backend": "jnp"}, id="jnp"),
            pytest.param({"backend": "jnp", "interpret": True},
                         id="pallas")]


# quantize=True with a generous eta keeps both steppers pinned at
# dt == dt_max, so the adaptive-dt control cannot amplify the f32
# pair-summation-order differences between the batched and in-jit
# force dispatches into divergent step sequences.
_H = dict(eta=0.5, eta_init=0.5, dt_max=1.0 / 64, quantize=True)


@pytest.mark.parametrize("kw", BACKENDS)
def test_macro_hermite_matches_in_jit(kw):
    n, t_end = 300, 4.0 / 64
    state = plummer(n, jax.random.PRNGKey(3))
    force = make_force_model(eps=0.05, **kw)

    ref = Hermite4(force=force, **_H)
    c_ref = ref.init(state)
    c_ref = jax.jit(ref.advance_to)(c_ref, t_end)

    mac = MacroHermite(force=force, n_batches=2, **_H)
    c_mac = mac.init(state)
    c_mac = mac.advance_to_bounded(c_mac, t_end, max_steps=100)

    assert int(c_mac.n_steps) == int(c_ref.n_steps)
    assert float(c_mac.state.time) == pytest.approx(t_end)
    scale = float(jnp.max(jnp.abs(c_ref.state.pos)))
    assert float(jnp.max(jnp.abs(c_mac.state.pos - c_ref.state.pos))) \
        < 1e-5 * scale
    vscale = float(jnp.max(jnp.abs(c_ref.state.vel)))
    assert float(jnp.max(jnp.abs(c_mac.state.vel - c_ref.state.vel))) \
        < 1e-5 * vscale
    # step bound respected
    c2 = mac.init(state)
    c2 = mac.advance_to_bounded(c2, t_end, max_steps=2)
    assert int(c2.n_steps) == 2


@pytest.mark.parametrize("kw", BACKENDS)
def test_macro_hermite_pec2(kw):
    """The PEC² option re-evaluates through the batched path too."""
    n, t_end = 200, 2.0 / 64
    state = plummer(n, jax.random.PRNGKey(11))
    force = make_force_model(eps=0.05, **kw)
    ref = Hermite4(force=force, pec2=True, **_H)
    c_ref = jax.jit(ref.advance_to)(ref.init(state), t_end)
    mac = MacroHermite(force=force, pec2=True, n_batches=2, **_H)
    c_mac = mac.advance_to_bounded(mac.init(state), t_end, max_steps=50)
    scale = float(jnp.max(jnp.abs(c_ref.state.pos)))
    assert float(jnp.max(jnp.abs(c_mac.state.pos - c_ref.state.pos))) \
        < 1e-5 * scale


def test_macro_hermite_driver_and_elasticity(tmp_path):
    """run() with kind='hermite' + macro_batches: host-stepped advance,
    precomputed-phi diagnostics, and snapshot elasticity with the in-jit
    Hermite4 (same aux contract both directions)."""
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.run import run

    def cfg(out, t_end, macro):
        return SimConfig.from_dict({
            "ic": {"kind": "plummer", "n": 192, "seed": 5},
            "integrator": {"kind": "hermite", "eps": 0.05, "eta": 0.5,
                           "eta_init": 0.5, "dt_max": 1.0 / 64,
                           "quantize": True, "macro_batches": macro},
            "backend": "jnp",
            "output": {"out_dir": out, "t_end": t_end,
                       "diag_every": 2.0 / 64, "snap_every": 2.0 / 64,
                       "stdout": False},
        })

    res = run(cfg(str(tmp_path / "mh"), 4.0 / 64, macro=2))
    assert float(res.state.time) == pytest.approx(4.0 / 64)
    assert np.isfinite(res.diagnostics["E_tot"]).all()
    assert abs(res.diagnostics["dE_over_E_int"][-1]) < 1e-4

    # macro first leg -> in-jit second leg, and the reverse
    out = str(tmp_path / "elastic")
    run(cfg(out, 2.0 / 64, macro=2))
    res1 = run(cfg(out, 4.0 / 64, macro=0), resume=True)
    out2 = str(tmp_path / "elastic2")
    run(cfg(out2, 2.0 / 64, macro=0))
    res2 = run(cfg(out2, 4.0 / 64, macro=2), resume=True)
    ref = run(cfg(str(tmp_path / "ref"), 4.0 / 64, macro=0))
    np.testing.assert_array_equal(np.asarray(res1.state.pos),
                                  np.asarray(ref.state.pos))
    np.testing.assert_array_equal(np.asarray(res2.state.pos),
                                  np.asarray(ref.state.pos))
