"""Extended precision tier on the mesh.

Round-2 VERDICT Missing #1: `build_scene` hard-rejected precision != f32
on a mesh. These tests pin the closure:

  * sharded-extended (jnp backend AND the Pallas backend selected,
    allgather AND ring) ≡ the single-chip `ops/df32.accel_extended`
    oracle — the tier's hi/lo sweeps are the XLA-compiled df32 twins on
    every backend;
  * sharded-extended error vs an f64 oracle is far below sharded-f32's
    (the capability claim, not just self-consistency);
  * the extended active-row (block-timestep) psum path matches its twin;
  * build_scene now accepts precision="extended" with a mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.ops import df32, gravity
from oc_nbody_tpu.parallel import make_mesh, make_sharded_force

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def _cluster(n=100, seed=7):
    key = jax.random.PRNGKey(seed)
    kp, km, kv = jax.random.split(key, 3)
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    vel = 0.3 * jax.random.normal(kv, (n, 3), jnp.float64)
    mass = jax.random.uniform(km, (n,), jnp.float64, 0.5, 1.5) / n
    return pos, vel, mass


# ---- sharded extended == single-chip extended oracle ---------------------

@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_extended_accel_jnp(mode):
    pos, _, mass = _cluster(n=100)   # not divisible by 8: padding covered
    sf = make_sharded_force(eps=0.05, mesh=make_mesh(8), mode=mode,
                            backend="jnp", precision="extended")
    out = jax.jit(sf.accel)(pos, mass)
    ref = df32.accel_extended(pos, mass, eps=0.05, chunk=64)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    # same EFT math, different summation order (+ Kahan across shards)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-7 * scale, rtol=0)


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_extended_accel_pallas_interpret(mode):
    pos, _, mass = _cluster(n=96)
    sf = make_sharded_force(eps=0.05, mesh=make_mesh(8), mode=mode,
                            backend="pallas", interpret=True,
                            precision="extended")
    out = jax.jit(sf.accel)(pos, mass)
    ref = df32.accel_extended(pos, mass, eps=0.05, chunk=64)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-6 * scale, rtol=0)


def test_sharded_extended_beats_f32():
    """The point of the tier: sharded-extended tracks the f64 oracle far
    better than sharded-f32 where it matters — close pairs, whose r²
    lives below the f32 cancellation floor of O(1) coordinates. Inject a
    tight pair (separation 1e-3 across a shard boundary) and compare the
    force error against the f64 oracle."""
    pos, _, mass = _cluster(n=512, seed=3)
    # a tight pair split across shards (rows 0 and 300: different slabs)
    pos = pos.at[300].set(pos[0] + jnp.array([1e-3, -0.7e-3, 0.4e-3]))
    eps = 0.0005
    ref = gravity.accel(pos, mass, eps=eps, compute_dtype=jnp.float64,
                        chunk=512)
    mesh = make_mesh(8)
    err = {}
    for prec in ("f32", "extended"):
        sf = make_sharded_force(eps=eps, mesh=mesh, mode="ring",
                                backend="jnp", precision=prec)
        out = jax.jit(sf.accel)(pos, mass)
        rel = jnp.abs(out - ref) / jnp.linalg.norm(ref, axis=1, keepdims=True)
        err[prec] = float(jnp.max(rel))
    assert err["extended"] < err["f32"] / 20, err


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_extended_potential_jnp(mode):
    pos, _, mass = _cluster(n=128)
    sf = make_sharded_force(eps=0.05, mesh=make_mesh(8), mode=mode,
                            backend="jnp", precision="extended")
    acc, phi, phi_ext = jax.jit(sf.accel_potential)(pos, mass)
    ref_a, ref_p = df32.accel_potential_extended(pos, mass, eps=0.05,
                                                 chunk=64)
    # single-chip contract: forces.py adds self_phi to the tier phi
    ref_p = ref_p + gravity.self_phi(jnp.asarray(mass, jnp.float32),
                                     jnp.float32(0.05), jnp.float32(1.0))
    a_scale = float(jnp.max(jnp.linalg.norm(ref_a, axis=1)))
    p_scale = float(jnp.max(jnp.abs(ref_p)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref_a),
                               atol=3e-7 * a_scale, rtol=0)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref_p),
                               atol=3e-7 * p_scale, rtol=0)
    assert float(jnp.max(jnp.abs(phi_ext))) == 0.0


@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_sharded_extended_jerk_jnp(mode):
    pos, vel, mass = _cluster(n=128)
    sf = make_sharded_force(eps=0.05, mesh=make_mesh(8), mode=mode,
                            backend="jnp", precision="extended")
    acc, jerk = jax.jit(sf.accel_jerk)(pos, vel, mass)
    ref_a, ref_j = df32.accel_jerk_extended(pos, vel, mass, eps=0.05,
                                            chunk=64)
    a_scale = float(jnp.max(jnp.linalg.norm(ref_a, axis=1)))
    j_scale = float(jnp.max(jnp.linalg.norm(ref_j, axis=1)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref_a),
                               atol=3e-7 * a_scale, rtol=0)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(ref_j),
                               atol=1e-6 * j_scale, rtol=0)


def test_sharded_extended_active_rows_jnp():
    """Block-timestep active-row evaluation at the extended tier on the
    mesh: psum-reduced hi/lo partials == the single-chip hilo twin."""
    pos, vel, mass = _cluster(n=128)
    rows, vrows = pos[:16], vel[:16]
    sf = make_sharded_force(eps=0.05, mesh=make_mesh(8), mode="ring",
                            backend="jnp", precision="extended")
    acc, jerk = jax.jit(sf.accel_jerk_on_rows)(rows, vrows, pos, vel, mass)
    # oracle: f64 rows evaluation
    ref_a, ref_j = gravity.accel_jerk_rows(rows, vrows, pos, vel, mass,
                                           0.05, 1.0, 128)
    a_scale = float(jnp.max(jnp.linalg.norm(ref_a, axis=1)))
    j_scale = float(jnp.max(jnp.linalg.norm(ref_j, axis=1)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref_a),
                               atol=5e-7 * a_scale, rtol=0)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(ref_j),
                               atol=2e-6 * j_scale, rtol=0)


def test_jnp_hilo_twins_match_extended_oracle():
    """The df32 hilo twins serve the mesh, pruned and batched extended
    paths — they must reproduce accel_extended exactly (same math, same
    order up to chunking)."""
    pos, vel, mass = _cluster(n=200, seed=9)
    center = jnp.mean(pos, axis=0)
    hi, lo = df32.df_from_f64(pos - center)
    gm = jnp.asarray(mass, jnp.float32)
    out = df32.accel_rows_x_hilo(hi, lo, hi, lo, gm, jnp.float32(0.05),
                                 chunk=64)
    ref = df32.accel_extended(pos, mass, eps=0.05, chunk=64)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-7 * scale, rtol=0)


# ---- wiring --------------------------------------------------------------

def test_build_scene_accepts_extended_on_mesh():
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.scene import build_scene
    cfg = SimConfig()
    cfg.ic.n = 64
    cfg.integrator.precision = "extended"
    cfg.mesh.n_devices = 8
    cfg.backend = "jnp"
    scene = build_scene(cfg)
    assert scene.force.precision == "extended"
    acc = scene.force.accel(scene.state.pos, scene.state.mass)
    assert bool(jnp.all(jnp.isfinite(acc)))


def test_sharded_force_rejects_df32_and_rdma_extended():
    with pytest.raises(ValueError, match="df32"):
        make_sharded_force(eps=0.01, mesh=make_mesh(8), precision="df32")
    # the removed rdma mode is refused at every tier; the message points on
    with pytest.raises(ValueError, match="rdma.*ring"):
        make_sharded_force(eps=0.01, mesh=make_mesh(8), mode="rdma",
                           precision="extended")
