"""Pair-symmetric sharded force (mode="halfring") on the emulated mesh.

The halfring mode computes each unordered shard pair ONCE (cross-pair
kernels return action AND reaction) and delivers the reactions with one
psum_scatter — Newton's-3rd-law halving across shards
(parallel/force.py _halfring_sweep).
These tests pin sharded ≡ single-device oracle for every op at even D
(exercises the quadrant-split shared step), odd D (pure circulation), and
the D=1/D=2 edge cases, on both the jnp backend and the Pallas (Triton)
diagonal sweep through the interpreter (SURVEY.md §4.3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from oc_nbody_tpu.ops import gravity
from oc_nbody_tpu.parallel import make_sharded_force

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)

EPS = 0.05


def _cluster(n=100, seed=3):
    key = jax.random.PRNGKey(seed)
    kp, km, kv = jax.random.split(key, 3)
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    vel = 0.3 * jax.random.normal(kv, (n, 3), jnp.float64)
    mass = jnp.abs(jax.random.normal(km, (n,), jnp.float64)) / n + 0.01
    return pos, vel, mass


def _mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("rows",))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_halfring_accel_matches_single(d):
    """Even d exercises the quadrant-split shared step; odd d the pure
    circulation; d=1 the diagonal-only degenerate case."""
    pos, _, mass = _cluster(n=100)  # not divisible by d: exercises padding
    sf = make_sharded_force(eps=EPS, mesh=_mesh(d), mode="halfring",
                            backend="jnp")
    out = jax.jit(sf.accel)(pos, mass)
    ref = gravity.accel(pos, mass, eps=EPS)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-6 * scale)


@pytest.mark.parametrize("d", [5, 8])
def test_halfring_potential_matches_single(d):
    pos, _, mass = _cluster(n=96)
    sf = make_sharded_force(eps=EPS, mesh=_mesh(d), mode="halfring",
                            backend="jnp")
    acc, phi, phi_ext = jax.jit(sf.accel_potential)(pos, mass)
    acc_ref, phi_ref = gravity.accel_potential(pos, mass, eps=EPS)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi_ref),
                               atol=3e-6 * float(jnp.max(jnp.abs(phi_ref))))
    scale = float(jnp.max(jnp.linalg.norm(acc_ref, axis=1)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref),
                               atol=3e-6 * scale)
    assert float(jnp.max(jnp.abs(phi_ext))) == 0.0


@pytest.mark.parametrize("d", [5, 8])
def test_halfring_jerk_matches_single(d):
    pos, vel, mass = _cluster(n=104)
    sf = make_sharded_force(eps=EPS, mesh=_mesh(d), mode="halfring",
                            backend="jnp")
    acc, jerk = jax.jit(sf.accel_jerk)(pos, vel, mass)
    acc_ref, jerk_ref = gravity.accel_jerk(pos, vel, mass, eps=EPS)
    a_s = float(jnp.max(jnp.linalg.norm(acc_ref, axis=1)))
    j_s = float(jnp.max(jnp.linalg.norm(jerk_ref, axis=1)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref),
                               atol=3e-6 * a_s)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_ref),
                               atol=3e-6 * j_s)


def test_halfring_momentum_conservation():
    """Σ m·a ≈ 0: the action-reaction bookkeeping across the slot buffer
    and the psum_scatter delivery must preserve Newton's 3rd law."""
    pos, _, mass = _cluster(n=120, seed=11)
    sf = make_sharded_force(eps=EPS, mesh=_mesh(8), mode="halfring",
                            backend="jnp")
    acc = jax.jit(sf.accel)(pos, mass)
    ptot = jnp.sum(mass[:, None] * acc, axis=0)
    scale = float(jnp.sum(mass[:, None] * jnp.abs(acc)))
    assert float(jnp.max(jnp.abs(ptot))) < 1e-6 * scale


class TestPallasHalfring:
    """The production composition: the Pallas (Triton) diagonal sweep
    with the jnp cross-pair sweeps inside the halfring shard_map, via the
    interpreter."""

    @pytest.mark.parametrize("d", [2, 8])
    def test_accel(self, d):
        pos, _, mass = _cluster(n=100)
        sf = make_sharded_force(eps=EPS, mesh=_mesh(d), mode="halfring",
                                backend="pallas", interpret=True)
        out = jax.jit(sf.accel)(pos, mass)
        ref = gravity.accel(pos, mass, eps=EPS)
        scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=3e-6 * scale)

    def test_potential_and_jerk(self):
        pos, vel, mass = _cluster(n=96)
        sf = make_sharded_force(eps=EPS, mesh=_mesh(8), mode="halfring",
                                backend="pallas", interpret=True)
        acc, phi, _ = jax.jit(sf.accel_potential)(pos, mass)
        acc_ref, phi_ref = gravity.accel_potential(pos, mass, eps=EPS)
        np.testing.assert_allclose(
            np.asarray(phi), np.asarray(phi_ref),
            atol=3e-6 * float(jnp.max(jnp.abs(phi_ref))))
        aj, jj = jax.jit(sf.accel_jerk)(pos, vel, mass)
        aj_ref, jj_ref = gravity.accel_jerk(pos, vel, mass, eps=EPS)
        np.testing.assert_allclose(
            np.asarray(jj), np.asarray(jj_ref),
            atol=3e-6 * float(jnp.max(jnp.linalg.norm(jj_ref, axis=1))))

    def test_extended_tier(self):
        """Extended halfring with the Pallas backend selected (the tier's
        hi/lo sweeps are the XLA-compiled df32 twins) ≡ the df32 oracle."""
        from oc_nbody_tpu.ops import df32

        pos, vel, mass = _cluster(n=96, seed=9)
        sf = make_sharded_force(eps=EPS, mesh=_mesh(8), mode="halfring",
                                backend="pallas", interpret=True,
                                precision="extended")
        out = jax.jit(sf.accel)(pos, mass)
        ref = df32.accel_extended(pos, mass, eps=EPS, chunk=64)
        scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=3e-6 * scale)
        aj, jj = jax.jit(sf.accel_jerk)(pos, vel, mass)
        _, jj_ref = df32.accel_jerk_extended(pos, vel, mass, eps=EPS,
                                             chunk=64)
        np.testing.assert_allclose(
            np.asarray(jj), np.asarray(jj_ref),
            atol=3e-6 * float(jnp.max(jnp.linalg.norm(jj_ref, axis=1))))


@pytest.mark.parametrize("d", [5, 8])
def test_halfring_extended_tier_matches_df32_oracle(d):
    """precision="extended" through halfring (hi/lo planes circulate,
    cross-pair-x kernels, one-sided diag): must agree with the
    single-device extended oracle to the tier's own accuracy."""
    from oc_nbody_tpu.ops import df32

    pos, vel, mass = _cluster(n=112, seed=5)
    sf = make_sharded_force(eps=EPS, mesh=_mesh(d), mode="halfring",
                            backend="jnp", precision="extended")
    out = jax.jit(sf.accel)(pos, mass)
    ref = df32.accel_extended(pos, mass, eps=EPS, chunk=64)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=1)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-6 * scale)

    acc, phi, _ = jax.jit(sf.accel_potential)(pos, mass)
    _, phi_ref = df32.accel_potential_extended(pos, mass, eps=EPS, chunk=64)
    # the tier oracle's phi INCLUDES the softened self term (its
    # docstring contract); ShardedForce returns the corrected phi
    phi_ref = phi_ref + gravity.self_phi(jnp.asarray(mass, jnp.float32),
                                         jnp.float32(EPS), jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi_ref),
                               atol=3e-6 * float(jnp.max(jnp.abs(phi_ref))))

    aj, jj = jax.jit(sf.accel_jerk)(pos, vel, mass)
    _, jj_ref = df32.accel_jerk_extended(pos, vel, mass, eps=EPS, chunk=64)
    np.testing.assert_allclose(
        np.asarray(jj), np.asarray(jj_ref),
        atol=3e-6 * float(jnp.max(jnp.linalg.norm(jj_ref, axis=1))))


def test_cross_pair_jnp_matches_one_sided():
    """The jnp cross-pair building block ≡ two one-sided rows calls (f64:
    exact up to summation order)."""
    key = jax.random.PRNGKey(1)
    kA, kB, kv = jax.random.split(key, 3)
    nA, nB = 37, 53
    posA = jax.random.normal(kA, (nA, 3), jnp.float64)
    posB = jax.random.normal(kB, (nB, 3), jnp.float64) + 0.5
    velA = jax.random.normal(kv, (nA, 3), jnp.float64)
    velB = jax.random.normal(kv, (nB, 3), jnp.float64) * 0.3
    mA = jnp.abs(jax.random.normal(kA, (nA,), jnp.float64)) + 0.1
    mB = jnp.abs(jax.random.normal(kB, (nB,), jnp.float64)) + 0.1
    G = 1.3

    aA, aB = gravity.accel_cross_pair(posA, posB, mA, mB, EPS, G, chunk=16)
    np.testing.assert_allclose(
        np.asarray(aA), np.asarray(gravity.accel_rows(posA, posB, mB, EPS, G, 16)),
        rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(aB), np.asarray(gravity.accel_rows(posB, posA, mA, EPS, G, 16)),
        rtol=1e-12)

    aA, pA, aB, pB = gravity.accel_potential_cross_pair(
        posA, posB, mA, mB, EPS, G, chunk=16)
    _, pA_ref = gravity.accel_potential_rows(posA, posB, mB, EPS, G, 16)
    _, pB_ref = gravity.accel_potential_rows(posB, posA, mA, EPS, G, 16)
    np.testing.assert_allclose(np.asarray(pA), np.asarray(pA_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pB), np.asarray(pB_ref), rtol=1e-12)

    aA, jA, aB, jB = gravity.accel_jerk_cross_pair(
        posA, velA, posB, velB, mA, mB, EPS, G, chunk=16)
    _, jA_ref = gravity.accel_jerk_rows(posA, velA, posB, velB, mB, EPS, G, 16)
    _, jB_ref = gravity.accel_jerk_rows(posB, velB, posA, velA, mA, EPS, G, 16)
    np.testing.assert_allclose(np.asarray(jA), np.asarray(jA_ref), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(jB), np.asarray(jB_ref), rtol=1e-11,
                               atol=1e-12)
