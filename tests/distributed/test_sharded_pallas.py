"""Pallas kernels INSIDE shard_map at D>1 — the production config-5 path.

`parallel/force.py` selects the Pallas (Triton) kernels on a GPU, so the
real multi-device execution runs them inside the ring / allgather
shard_map. These tests run that exact composition through the Pallas
interpreter (``interpret=True``) on the 8-device emulated CPU mesh
(SURVEY.md §4.3) and assert sharded-pallas ≡ single-device oracle for
accel / potential / jerk in BOTH source modes, plus the block-timestep
active-row psum path, the split-source grid and a full KDK trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.ops import gravity, triton_gravity
from oc_nbody_tpu.parallel import make_mesh, make_sharded_force

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def make_sharded_force_interp(**kw):
    return make_sharded_force(backend="pallas", interpret=True, **kw)


def _cluster(n=100, seed=7):
    key = jax.random.PRNGKey(seed)
    kp, km = jax.random.split(key)
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    vel = 0.3 * jax.random.normal(km, (n, 3), jnp.float64)
    mass = jnp.ones(n) / n
    return pos, vel, mass


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_pallas_accel(mode):
    pos, _, mass = _cluster(n=100)  # not divisible by 8: exercises padding
    sf = make_sharded_force_interp(eps=0.05, mesh=make_mesh(8),
                                   mode=mode)
    out = jax.jit(sf.accel)(pos, mass)
    ref = gravity.accel(pos, mass, eps=0.05)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=5e-6 * scale)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_pallas_potential(mode):
    pos, _, mass = _cluster(n=96)
    sf = make_sharded_force_interp(eps=0.05, mesh=make_mesh(8),
                                   mode=mode)
    acc, phi, _ = jax.jit(sf.accel_potential)(pos, mass)
    _, phi_ref = gravity.accel_potential(pos, mass, eps=0.05)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi_ref), rtol=3e-5)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_pallas_jerk(mode):
    pos, vel, mass = _cluster(n=80)
    sf = make_sharded_force_interp(eps=0.05, mesh=make_mesh(8),
                                   mode=mode)
    acc, jerk = jax.jit(sf.accel_jerk)(pos, vel, mass)
    acc_ref, jerk_ref = gravity.accel_jerk(pos, vel, mass, eps=0.05)
    ascale = float(jnp.max(jnp.linalg.norm(acc_ref, axis=1)))
    jscale = float(jnp.max(jnp.linalg.norm(jerk_ref, axis=1)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref),
                               atol=5e-6 * ascale)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_ref),
                               atol=5e-5 * jscale)


def test_sharded_pallas_matches_sharded_jnp():
    """Backend equivalence inside the SAME ring decomposition."""
    pos, vel, mass = _cluster(n=128)
    mesh = make_mesh(8)
    sf_p = make_sharded_force_interp(eps=0.05, mesh=mesh, mode="ring")
    sf_j = make_sharded_force(eps=0.05, mesh=mesh, mode="ring", backend="jnp")
    a_p, j_p = jax.jit(sf_p.accel_jerk)(pos, vel, mass)
    a_j, j_j = jax.jit(sf_j.accel_jerk)(pos, vel, mass)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_j), atol=2e-6)
    np.testing.assert_allclose(np.asarray(j_p), np.asarray(j_j), atol=2e-5)


def test_sharded_pallas_active_rows_psum():
    """The block-timestep path: replicated active rows vs row-sharded
    sources, partials psum-reduced — with the Pallas rows kernel."""
    pos, vel, mass = _cluster(n=96)
    rows = pos[:16]
    vrows = vel[:16]
    sf = make_sharded_force_interp(eps=0.05, mesh=make_mesh(8))
    acc, jerk = jax.jit(sf.accel_jerk_on_rows)(rows, vrows, pos, vel, mass)
    acc_ref, jerk_ref = gravity.accel_jerk_rows(
        rows.astype(jnp.float32), vrows.astype(jnp.float32),
        pos.astype(jnp.float32), vel.astype(jnp.float32),
        mass.astype(jnp.float32), jnp.float32(0.05), jnp.float32(1.0), 1024)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref), atol=5e-5)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_ref),
                               atol=5e-4)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_streamed_pallas(mode, monkeypatch):
    """Split-source grid INSIDE shard_map: a shard has few row blocks, so
    the kernels split its sources over the second grid axis and add the
    partials (triton_gravity._n_split). Forced here by shrinking the tiles
    below the per-shard sizes."""
    for kind in triton_gravity.TILES:
        monkeypatch.setitem(triton_gravity.TILES, kind, (8, 4, 4, 2))
    triton_gravity._sweep.clear_cache()
    pos, vel, mass = _cluster(n=120)
    sf = make_sharded_force_interp(eps=0.05, mesh=make_mesh(8),
                                   mode=mode)
    out = jax.jit(sf.accel)(pos, mass)
    ref = gravity.accel(pos, mass, eps=0.05)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=5e-6 * scale)
    acc, jerk = jax.jit(sf.accel_jerk)(pos, vel, mass)
    _, jerk_ref = gravity.accel_jerk(pos, vel, mass, eps=0.05)
    jscale = float(jnp.max(jnp.linalg.norm(jerk_ref, axis=1)))
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_ref),
                               atol=5e-5 * jscale)
    acc2, phi, _ = jax.jit(sf.accel_potential)(pos, mass)
    _, phi_ref = gravity.accel_potential(pos, mass, eps=0.05)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi_ref),
                               rtol=3e-5)
    triton_gravity._sweep.clear_cache()


def test_sharded_pallas_kdk_trajectory():
    """Short KDK trajectory: Pallas-inside-ring ≡ single-device jnp."""
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
    from oc_nbody_tpu.models.plummer import plummer

    state = plummer(128, jax.random.PRNGKey(31))
    sf = make_sharded_force_interp(eps=1.0 / 64, mesh=make_mesh(8),
                                   mode="ring")
    fm = make_force_model(eps=1.0 / 64, backend="jnp")

    def advance(st, f):
        stepper = LeapfrogKDK(force=f, dt=1.0 / 256)
        return jax.jit(stepper.advance, static_argnums=1)(stepper.init(st), 16)

    c_sh = advance(state, sf)
    c_ref = advance(state, fm)
    np.testing.assert_allclose(np.asarray(c_sh.state.pos),
                               np.asarray(c_ref.state.pos), atol=1e-5)
