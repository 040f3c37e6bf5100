"""Ring-mode cross-shard compensation must survive XLA compilation.

ADVICE round-2 (medium): parallel/force._two_sum compiles through XLA
(shard_map + fori_loop), whose algebraic simplifier rewrites the
``(t - acc) - y`` residual to zero inside fused graphs — silently
degrading the Kahan step to plain f32 summation. The fix pins the rounded
sum with ``jax.lax.optimization_barrier`` (same as ops/df32.two_sum).

With the barrier in place, compensated accumulation across D=8 source
shards must track the f64 oracle strictly better than plain summation —
an assertion that FAILS if the compensation is simplified away, because
then both variants produce identical results.
"""
import jax
import jax.numpy as jnp
import numpy as np

from oc_nbody_tpu.ops import gravity
from oc_nbody_tpu.parallel import force as pforce
from oc_nbody_tpu.parallel import make_mesh, make_sharded_force


def test_ring_compensation_beats_plain(monkeypatch):
    key = jax.random.PRNGKey(17)
    kp, km = jax.random.split(key)
    n = 4096
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    mass = jax.random.uniform(km, (n,), jnp.float64, 0.5, 1.5) / n
    eps = 0.05
    # f64 oracle on the same centred geometry the sharded engine uses
    ref = gravity.accel(pos, mass, eps, compute_dtype=jnp.float64, chunk=1024)

    mesh = make_mesh(8)
    sf = make_sharded_force(eps=eps, mesh=mesh, mode="ring", backend="jnp")
    a_comp = np.asarray(sf.accel(pos, mass))

    # degrade the Kahan step to plain summation and re-evaluate
    monkeypatch.setattr(pforce, "_two_sum",
                        lambda acc, comp, partial: (acc + partial, comp))
    sf2 = make_sharded_force(eps=eps, mesh=mesh, mode="ring", backend="jnp")
    a_plain = np.asarray(sf2.accel(pos, mass))

    ref = np.asarray(ref)
    err_comp = np.abs(a_comp - ref)
    err_plain = np.abs(a_plain - ref)
    # strict improvement in the aggregate (12288 samples: the cross-shard
    # sum is 8 f32 additions whose rounding the Kahan step recovers)
    assert err_comp.mean() < err_plain.mean(), (
        err_comp.mean(), err_plain.mean())
    # and never meaningfully worse pointwise
    scale = np.abs(ref).max()
    assert err_comp.max() <= err_plain.max() + 1e-7 * scale
