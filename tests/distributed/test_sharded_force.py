"""Multi-device force path on an 8-device emulated CPU mesh (SURVEY.md §4.3).

The same tests run unchanged on real devices: the mesh comes from
jax.devices(), whatever they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.hermite import Hermite4
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu.models.plummer import plummer
from oc_nbody_tpu.models.potentials import milky_way
from oc_nbody_tpu.ops import gravity
from oc_nbody_tpu.parallel import make_mesh, make_sharded_force
from oc_nbody_tpu.utils.units import G_PC_MYR_MSUN


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def _cluster(n=100, seed=0):
    key = jax.random.PRNGKey(seed)
    kp, km = jax.random.split(key)
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    vel = 0.3 * jax.random.normal(km, (n, 3), jnp.float64)
    mass = jnp.ones(n) / n
    return pos, vel, mass


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_accel_matches_single(mode):
    pos, _, mass = _cluster(n=100)  # deliberately not divisible by 8
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=0.05, mesh=mesh, mode=mode, backend="jnp")
    out = jax.jit(sf.accel)(pos, mass)
    ref = gravity.accel(pos, mass, eps=0.05)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-6 * scale)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_potential_matches_single(mode):
    pos, _, mass = _cluster(n=96)
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=0.05, mesh=mesh, mode=mode, backend="jnp")
    acc, phi, phi_ext = jax.jit(sf.accel_potential)(pos, mass)
    _, phi_ref = gravity.accel_potential(pos, mass, eps=0.05)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi_ref), rtol=3e-5)
    assert float(jnp.max(jnp.abs(phi_ext))) == 0.0


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_jerk_matches_single(mode):
    pos, vel, mass = _cluster(n=80)
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=0.05, mesh=mesh, mode=mode, backend="jnp")
    acc, jerk = jax.jit(sf.accel_jerk)(pos, vel, mass)
    acc_ref, jerk_ref = gravity.accel_jerk(pos, vel, mass, eps=0.05)
    jscale = float(jnp.max(jnp.linalg.norm(jerk_ref, axis=1)))
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_ref),
                               atol=3e-5 * jscale)


def test_sharded_external_potential():
    """External MW field applies identically under sharding."""
    pos, _, mass = _cluster(n=64)
    pos = pos + jnp.array([8000.0, 0.0, 0.0])
    mw = milky_way(G=G_PC_MYR_MSUN)
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=0.05, G=G_PC_MYR_MSUN, external=mw, mesh=mesh,
                            backend="jnp")
    fm = make_force_model(eps=0.05, G=G_PC_MYR_MSUN, external=mw, backend="jnp")
    out = jax.jit(sf.accel)(pos, mass)
    ref = fm.accel(pos, mass)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5 * scale)


def test_sharded_kdk_trajectory_matches_single():
    """A short KDK integration on the mesh tracks the single-device one."""
    state = plummer(128, jax.random.PRNGKey(31))
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=1.0 / 64, mesh=mesh, backend="jnp")
    fm = make_force_model(eps=1.0 / 64, backend="jnp")
    advance = lambda st, f: jax.jit(  # noqa: E731
        LeapfrogKDK(force=f, dt=1.0 / 256).advance, static_argnums=1
    )(LeapfrogKDK(force=f, dt=1.0 / 256).init(st), 32)
    c_sh = advance(state, sf)
    c_ref = advance(state, fm)
    np.testing.assert_allclose(np.asarray(c_sh.state.pos),
                               np.asarray(c_ref.state.pos), atol=1e-6)


def test_sharded_hermite_runs():
    state = plummer(64, jax.random.PRNGKey(33))
    mesh = make_mesh(8)
    sf = make_sharded_force(eps=1.0 / 64, mesh=mesh, mode="ring", backend="jnp")
    stepper = Hermite4(force=sf, eta=0.02)
    carry = jax.jit(stepper.advance, static_argnums=1)(stepper.init(state), 8)
    assert bool(jnp.all(jnp.isfinite(carry.state.pos)))
    assert float(carry.state.time) > 0
