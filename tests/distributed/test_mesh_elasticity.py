"""Snapshots are mesh-agnostic: a checkpoint written on an 8-device run
restores and continues on a single device (SURVEY.md §5 elastic recovery:
'restart on a different mesh works because state is mesh-agnostic')."""
import jax
import numpy as np
import pytest

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu.io.snapshot import read_snapshot, write_snapshot
from oc_nbody_tpu.models.plummer import plummer
from oc_nbody_tpu.parallel import make_mesh, make_sharded_force

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def test_restart_on_different_mesh(tmp_path):
    state = plummer(96, jax.random.PRNGKey(61))
    sf8 = make_sharded_force(eps=1.0 / 32, mesh=make_mesh(8), backend="jnp")
    f1 = make_force_model(eps=1.0 / 32, backend="jnp")
    dt = 1.0 / 256

    # run 40 steps on the 8-device mesh, checkpoint
    s8 = LeapfrogKDK(force=sf8, dt=dt)
    c8 = jax.jit(s8.advance, static_argnums=1)(s8.init(state), 40)
    path = str(tmp_path / "mesh8.npz")
    write_snapshot(path, c8.state, aux=s8.checkpoint_aux(c8),
                   integrator_kind="kdk")

    # restore on a single device and continue
    snap = read_snapshot(path)
    s1 = LeapfrogKDK(force=f1, dt=dt)
    c1 = s1.restore(snap.state, snap.aux)
    c1 = jax.jit(s1.advance, static_argnums=1)(c1, 40)

    # reference: the same 80 steps entirely on the mesh
    ref = jax.jit(s8.advance, static_argnums=1)(c8, 40)
    np.testing.assert_allclose(np.asarray(c1.state.pos),
                               np.asarray(ref.state.pos), atol=1e-7)


def test_restart_on_larger_mesh(tmp_path):
    """Single-device checkpoint continues on the 8-device mesh (scale-up)."""
    state = plummer(64, jax.random.PRNGKey(63))
    f1 = make_force_model(eps=1.0 / 32, backend="jnp")
    s1 = LeapfrogKDK(force=f1, dt=1.0 / 256)
    c1 = jax.jit(s1.advance, static_argnums=1)(s1.init(state), 30)
    path = str(tmp_path / "mesh1.npz")
    write_snapshot(path, c1.state, aux=s1.checkpoint_aux(c1),
                   integrator_kind="kdk")

    snap = read_snapshot(path)
    sf8 = make_sharded_force(eps=1.0 / 32, mesh=make_mesh(8), mode="ring",
                             backend="jnp")
    s8 = LeapfrogKDK(force=sf8, dt=1.0 / 256)
    c8 = jax.jit(s8.advance, static_argnums=1)(s8.restore(snap.state, snap.aux), 30)

    ref = jax.jit(s1.advance, static_argnums=1)(c1, 30)
    np.testing.assert_allclose(np.asarray(c8.state.pos),
                               np.asarray(ref.state.pos), atol=1e-7)
