"""Double-f32 ("df32") arithmetic and extended-precision pairwise forces.

Accuracy tiers between the f32 sweep and full f64, for hardware whose f64
rate is far below its f32 rate. This module provides the standard
error-free-transformation toolbox (Knuth two-sum, Dekker split/two-prod —
exact on XLA f32; tests/unit/test_df32.py and chip_smoke.py check them
under jit on the CPU and on the GPU) and two force tiers built on it:

  * ``accel_extended`` — cheap hybrid: positions carried as (hi, lo) f32
    splits of the f64 input; pair separations get the lo-correction
    (dx = (hi_j - hi_i) + (lo_j - lo_i)), r² gets the first-order cross
    term, the hardware rsqrt (~1.1e-6/pair rel error, measured) gets one
    plain-f32 Newton refinement, and per-row accumulation is Neumaier-
    compensated. ~2x the ops of the f32 kernel.
  * ``accel_df`` — full df32: every pair quantity (separation, r²,
    rsqrt via df-Newton, weights, accumulation) is a (hi, lo) pair.
    ~48-bit effective mantissa; ~10x the f32 ops.

The f32 production kernels' per-pair error (~1-4e-6 rel, dominated by the
hardware rsqrt + f32 rounding) is the one accuracy term the round-2
measurements could not reduce (ROADMAP: refining the rsqrt alone does
nothing because r² itself is f32). These tiers attack exactly that term.

All functions are pure jnp — XLA compiles them for every backend — and
serve as the reference for any future kernel of these tiers.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# --------------------------------------------------------------------------
# error-free transformations (exact on XLA f32; checked under jit)
# --------------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly (Knuth).

    The rounded sum passes through an optimization barrier: XLA's
    algebraic simplifier otherwise treats s symbolically equal to a + b
    and rewrites the residual chain to zero in real arithmetic
    (measured inside fused graphs — quick_two_sum's `b - (s - a)`
    collapsed, costing the full lo word). The barrier pins s as an
    opaque f32 value; everything downstream is then honest float math."""
    s = jax.lax.optimization_barrier(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = jax.lax.optimization_barrier(a + b)
    e = b - (s - a)
    return s, e


def split(a):
    """a == hi + lo with hi carrying the top 12 significand bits.

    NOT the classic Dekker split (c = 4097*a; hi = c - (c - a)): XLA's
    algebraic simplifier rewrites `c - (c - a)` to `a` when the pattern
    is embedded in a larger fused graph (measured: two_prod exact in
    isolation, 1-ulp wrong inside df_rsqrt), silently destroying the
    error-free transformation. Masking the low 12 mantissa bits through
    an integer bitcast is arithmetically equivalent for normal inputs
    (|lo| has <= 12 significant bits, hi*hi / hi*lo / lo*lo all exact in
    f32) and immune to float simplification."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000),
                                      jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, no FMA needed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# --------------------------------------------------------------------------
# df32 numbers: (hi, lo) pairs with |lo| <= ulp(hi)/2
# --------------------------------------------------------------------------

def df_from_f64(a):
    """Split an f64 array into an f32 (hi, lo) pair (x64 must be on for
    f64 inputs; f32 inputs get lo = 0).

    hi passes through an optimization barrier: XLA:GPU treats the
    narrowing-then-widening convert pair f64 -> f32 -> f64 as removable
    (excess precision is allowed by default), which makes lo == 0 and
    silently drops every tier to plain f32 (measured on the H100: the
    extended and df32 accel errors equal the f32 path's)."""
    hi = jax.lax.optimization_barrier(a.astype(jnp.float32))
    lo = (a - hi.astype(a.dtype)).astype(jnp.float32)
    return hi, lo


def df_to_f64(x):
    return x[0].astype(jnp.float64) + x[1].astype(jnp.float64)


def df_add(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_sqr(x):
    p, e = two_prod(x[0], x[0])
    e = e + jnp.float32(2.0) * (x[0] * x[1])
    return quick_two_sum(p, e)


def df_mul_f(x, b):
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return quick_two_sum(p, e)


def df_rsqrt(x):
    """df32 1/sqrt(x): hardware seed -> one plain-f32 Newton -> one df32
    Newton (y <- y*(3 - x*y^2)/2, quadratic: err' ~ 1.5 err^2).

    The plain-f32 step is NOT optional: under jit the fused `lax.rsqrt`
    lowers to the hardware estimate (~2e-4 rel on AVX512, measured; eager
    CPU dispatch hides this behind a libm path), and one df step from
    2e-4 only reaches ~6e-8. f32-step first
    brings the seed to f32 accuracy, the df step then lands at ~1e-14."""
    y0 = jax.lax.rsqrt(x[0])
    y0 = y0 * (jnp.float32(1.5)
               - (jnp.float32(0.5) * x[0]) * (y0 * y0))
    y = (y0, jnp.zeros_like(y0))
    y2 = df_sqr(y)
    xy2 = df_mul(x, y2)
    three_minus = df_add((jnp.float32(3.0), jnp.float32(0.0)),
                         (-xy2[0], -xy2[1]))
    return df_mul_f(df_mul(y, three_minus), jnp.float32(0.5))


# --------------------------------------------------------------------------
# extended tier: hybrid f32 with lo-corrections (~2x cost)
# --------------------------------------------------------------------------

def _ext_row_block(rows_hi, rows_lo, src_hi, src_lo, gm, eps2, guarded,
                   want_phi=False, rows_vhi=None, rows_vlo=None,
                   src_vhi=None, src_vlo=None):
    """(accel[, phi][, jerk]) on a (B, 3) row block vs all sources,
    extended precision. Shapes: rows (B, 3); src (N, 3); gm (N,)."""
    d = src_hi[None, :, :] - rows_hi[:, None, :]          # exactly rounded
    e = src_lo[None, :, :] - rows_lo[:, None, :]          # lo correction
    # r^2 with first-order cross term; e^2 is below f32 resolution
    dd = jnp.sum(d * d, axis=-1)
    de = jnp.sum(d * e, axis=-1)
    u = dd + (jnp.float32(2.0) * de + eps2)
    if guarded:
        tiny = jnp.float32(1.1754944e-38)
        inv = jnp.where(u > 0, jax.lax.rsqrt(jnp.maximum(u, tiny)), 0.0)
    else:
        inv = jax.lax.rsqrt(u)
    # one Newton step removes the hardware rsqrt's ~1.1e-6/pair error
    # (measured; the remaining error is f32 arithmetic, ~1e-7)
    inv = inv * (jnp.float32(1.5)
                 - (jnp.float32(0.5) * u) * (inv * inv))
    gminv = gm[None, :] * inv
    w = gminv * (inv * inv)                               # (B, N)
    # force contribution uses the lo-corrected separation
    acc = jnp.sum(w[:, :, None] * (d + e), axis=1)
    out = (acc,)
    if want_phi:
        out = out + (-jnp.sum(gminv, axis=1),)
    if src_vhi is not None:
        dv = ((src_vhi[None, :, :] - rows_vhi[:, None, :])
              + (src_vlo[None, :, :] - rows_vlo[:, None, :]))
        rv = jnp.sum((d + e) * dv, axis=-1)
        s = (jnp.float32(3.0) * rv) * w * (inv * inv)
        jerk = jnp.sum(w[:, :, None] * dv
                       - s[:, :, None] * (d + e), axis=1)
        out = out + (jerk,)
    return out[0] if len(out) == 1 else out


def _ext_chunked(n, chunk, block):
    nb = -(-n // chunk)
    outs = jax.lax.map(block, jnp.arange(nb))
    return jax.tree_util.tree_map(
        lambda o: o.reshape((nb * chunk,) + o.shape[2:])[:n], outs)


def _pad0(a, n_pad):
    return jnp.pad(a, ((0, n_pad - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_extended(pos, mass, eps=0.0, G=1.0, chunk: int = 1024,
                   guarded: bool = True):
    """Extended-precision pairwise accel; f64 in/out (hi/lo split inside).
    ~5-10x lower per-pair force error than the f32 kernels at ~2x cost;
    use when the drift budget is tighter than the f32 force noise."""
    center = jnp.mean(pos, axis=0)
    hi, lo = df_from_f64(pos - center)
    gm = (jnp.asarray(G, jnp.float64) * mass).astype(jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)

    def block(i):
        rh = jax.lax.dynamic_slice_in_dim(hi_p, i * chunk, chunk)
        rl = jax.lax.dynamic_slice_in_dim(lo_p, i * chunk, chunk)
        return _ext_row_block(rh, rl, hi, lo, gm, eps2, guarded)

    return _ext_chunked(n, chunk, block).astype(pos.dtype)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_potential_extended(pos, mass, eps=0.0, G=1.0, chunk: int = 1024,
                             guarded: bool = True):
    """(accel, phi) extended tier. When eps > 0 phi INCLUDES the softened
    self term -G*m/eps: the u > 0 guard only masks exact-zero u, and a
    self pair has u = eps^2 > 0. Same contract as
    ops.gravity.accel_potential_rows — the caller adds
    gravity.self_phi(mass, eps, G) to cancel it (forces.py does)."""
    center = jnp.mean(pos, axis=0)
    hi, lo = df_from_f64(pos - center)
    gm = (jnp.asarray(G, jnp.float64) * mass).astype(jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)

    def block(i):
        rh = jax.lax.dynamic_slice_in_dim(hi_p, i * chunk, chunk)
        rl = jax.lax.dynamic_slice_in_dim(lo_p, i * chunk, chunk)
        return _ext_row_block(rh, rl, hi, lo, gm, eps2, guarded,
                              want_phi=True)

    acc, phi = _ext_chunked(n, chunk, block)
    return acc.astype(pos.dtype), phi.astype(pos.dtype)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_jerk_extended(pos, vel, mass, eps=0.0, G=1.0, chunk: int = 1024,
                        guarded: bool = True):
    """(accel, jerk) extended tier (Hermite force evaluation)."""
    center = jnp.mean(pos, axis=0)
    vcenter = jnp.mean(vel, axis=0)
    hi, lo = df_from_f64(pos - center)
    vhi, vlo = df_from_f64(vel - vcenter)
    gm = (jnp.asarray(G, jnp.float64) * mass).astype(jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)
    vhi_p, vlo_p = _pad0(vhi, nb * chunk), _pad0(vlo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_row_block(sl(hi_p), sl(lo_p), hi, lo, gm, eps2,
                              guarded, rows_vhi=sl(vhi_p),
                              rows_vlo=sl(vlo_p), src_vhi=vhi,
                              src_vlo=vlo)

    acc, jerk = _ext_chunked(n, chunk, block)
    return acc.astype(pos.dtype), jerk.astype(pos.dtype)


# --------------------------------------------------------------------------
# extended tier, pre-split (hi, lo)-plane entry points
# --------------------------------------------------------------------------
#
# All-f32 in/out on planes the caller split under ONE global centring:
# the extended tier's rows-vs-sources sweeps for the sharded, pruned and
# batched paths (parallel/force.py, forces.ForceModel) on every backend.

@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_rows_x_hilo(rhi, rlo, shi, slo, gm, eps, chunk: int = 256,
                      guarded: bool = True):
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nr = rhi.shape[0]
    nb = -(-nr // chunk)
    rh, rl = _pad0(rhi, nb * chunk), _pad0(rlo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_row_block(sl(rh), sl(rl), shi, slo, gm, eps2, guarded)

    return _ext_chunked(nr, chunk, block)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_potential_rows_x_hilo(rhi, rlo, shi, slo, gm, eps,
                                chunk: int = 256, guarded: bool = True):
    """When eps > 0 phi INCLUDES the softened self term for rows that are
    also sources (caller adds gravity.self_phi)."""
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nr = rhi.shape[0]
    nb = -(-nr // chunk)
    rh, rl = _pad0(rhi, nb * chunk), _pad0(rlo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_row_block(sl(rh), sl(rl), shi, slo, gm, eps2, guarded,
                              want_phi=True)

    return _ext_chunked(nr, chunk, block)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_jerk_rows_x_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm,
                           eps, chunk: int = 256, guarded: bool = True):
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nr = rhi.shape[0]
    nb = -(-nr // chunk)
    rh, rl = _pad0(rhi, nb * chunk), _pad0(rlo, nb * chunk)
    vh, vl = _pad0(vhi, nb * chunk), _pad0(vlo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_row_block(sl(rh), sl(rl), shi, slo, gm, eps2, guarded,
                              rows_vhi=sl(vh), rows_vlo=sl(vl),
                              src_vhi=svhi, src_vlo=svlo)

    return _ext_chunked(nr, chunk, block)


# --------------------------------------------------------------------------
# extended-tier cross-pair functions (halfring sharded mode): one sweep
# computes BOTH the action on set A and the reaction on set B for two
# DISJOINT sets (tested against the one-sided sweeps on the emulated mesh).
# Inputs are pre-split (hi, lo) f32 planes under ONE global centring and
# gm = G·mass f32, like the *_rows_x_hilo family above.
# --------------------------------------------------------------------------

def _ext_cross_block(rAhi_b, rAlo_b, gmA_b, shi, slo, gmB, eps2, guarded,
                     want_phi=False, vAhi_b=None, vAlo_b=None,
                     svhi=None, svlo=None):
    """One A-row block vs all of B, extended precision, BOTH directions.
    Returns (outs_on_A_block, reaction_contribs_on_B) tuples."""
    d = shi[None, :, :] - rAhi_b[:, None, :]
    e = slo[None, :, :] - rAlo_b[:, None, :]
    dd = jnp.sum(d * d, axis=-1)
    de = jnp.sum(d * e, axis=-1)
    u = dd + (jnp.float32(2.0) * de + eps2)
    if guarded:
        tiny = jnp.float32(1.1754944e-38)
        inv = jnp.where(u > 0, jax.lax.rsqrt(jnp.maximum(u, tiny)), 0.0)
    else:
        inv = jax.lax.rsqrt(u)
    inv = inv * (jnp.float32(1.5)
                 - (jnp.float32(0.5) * u) * (inv * inv))
    s = d + e
    gminvB = gmB[None, :] * inv
    gminvA = gmA_b[:, None] * inv
    wB = gminvB * (inv * inv)
    wA = gminvA * (inv * inv)
    accA = jnp.sum(wB[:, :, None] * s, axis=1)
    accB = -jnp.sum(wA[:, :, None] * s, axis=0)
    outsA, outsB = (accA,), (accB,)
    if want_phi:
        outsA = outsA + (-jnp.sum(gminvB, axis=1),)
        outsB = outsB + (-jnp.sum(gminvA, axis=0),)
    if svhi is not None:
        dv = ((svhi[None, :, :] - vAhi_b[:, None, :])
              + (svlo[None, :, :] - vAlo_b[:, None, :]))
        rv = jnp.sum(s * dv, axis=-1)
        sB = (jnp.float32(3.0) * rv) * wB * (inv * inv)
        sA = (jnp.float32(3.0) * rv) * wA * (inv * inv)
        outsA = outsA + (jnp.sum(wB[:, :, None] * dv
                                 - sB[:, :, None] * s, axis=1),)
        outsB = outsB + (-jnp.sum(wA[:, :, None] * dv
                                  - sA[:, :, None] * s, axis=0),)
    return outsA, outsB


def _ext_cross_scan(nA, chunk, block, accB0):
    """Scan A-row blocks, stacking A outputs and accumulating B reactions."""
    nb = -(-nA // chunk)

    def body(accB, i):
        outsA, outsB = block(i)
        return tuple(a + b for a, b in zip(accB, outsB)), outsA

    accB, outsA = jax.lax.scan(body, accB0, jnp.arange(nb))
    outsA = tuple(o.reshape((nb * chunk,) + o.shape[2:])[:nA] for o in outsA)
    return outsA, accB


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB, eps,
                            chunk: int = 256, guarded: bool = True):
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nA, nB = rAhi.shape[0], rBhi.shape[0]
    nb = -(-nA // chunk)
    rh, rl = _pad0(rAhi, nb * chunk), _pad0(rAlo, nb * chunk)
    gA = _pad0(gmA, nb * chunk)  # zero gm → zero reaction from pad rows

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_cross_block(sl(rh), sl(rl), sl(gA), rBhi, rBlo, gmB,
                                eps2, guarded)

    z3 = jnp.zeros((nB, 3), jnp.float32)
    (aA,), (aB,) = _ext_cross_scan(nA, chunk, block, (z3,))
    return aA, aB


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_potential_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB,
                                      eps, chunk: int = 256,
                                      guarded: bool = True):
    """Disjoint sets — neither phi contains a self term."""
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nA, nB = rAhi.shape[0], rBhi.shape[0]
    nb = -(-nA // chunk)
    rh, rl = _pad0(rAhi, nb * chunk), _pad0(rAlo, nb * chunk)
    gA = _pad0(gmA, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_cross_block(sl(rh), sl(rl), sl(gA), rBhi, rBlo, gmB,
                                eps2, guarded, want_phi=True)

    z3 = jnp.zeros((nB, 3), jnp.float32)
    z1 = jnp.zeros((nB,), jnp.float32)
    (aA, pA), (aB, pB) = _ext_cross_scan(nA, chunk, block, (z3, z1))
    return aA, pA, aB, pB


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_jerk_cross_pair_x_hilo(rAhi, rAlo, vAhi, vAlo, rBhi, rBlo,
                                 vBhi, vBlo, gmA, gmB, eps,
                                 chunk: int = 256, guarded: bool = True):
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    nA, nB = rAhi.shape[0], rBhi.shape[0]
    nb = -(-nA // chunk)
    rh, rl = _pad0(rAhi, nb * chunk), _pad0(rAlo, nb * chunk)
    vh, vl = _pad0(vAhi, nb * chunk), _pad0(vAlo, nb * chunk)
    gA = _pad0(gmA, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _ext_cross_block(sl(rh), sl(rl), sl(gA), rBhi, rBlo, gmB,
                                eps2, guarded, vAhi_b=sl(vh), vAlo_b=sl(vl),
                                svhi=vBhi, svlo=vBlo)

    z3 = jnp.zeros((nB, 3), jnp.float32)
    (aA, jA), (aB, jB) = _ext_cross_scan(nA, chunk, block, (z3, z3))
    return aA, jA, aB, jB


# --------------------------------------------------------------------------
# full df32 tier (~48-bit pairwise arithmetic)
# --------------------------------------------------------------------------

def _df_reduce(x):
    """f64 reduction of a df (hi, lo) pair over the source axis. O(N) per
    row — a vanishing fraction of the O(N^2) pairwise work, so emulated-
    f64 cost here is irrelevant."""
    return (jnp.sum(x[0].astype(jnp.float64), axis=-1)
            + jnp.sum(x[1].astype(jnp.float64), axis=-1))


def _df_row_block(rows_hi, rows_lo, src_hi, src_lo, gm_hi, gm_lo,
                  eps2_hi, eps2_lo, guarded, want_phi=False,
                  rows_vhi=None, rows_vlo=None, src_vhi=None,
                  src_vlo=None):
    """(accel[, phi][, jerk]) on a row block, every pair quantity df32."""
    # separations: exact hi-difference via two_sum, lo folded in, then
    # RE-NORMALIZED — for close pairs the lo-correction exceeds ulp(d)
    # (|lo| ~ ulp(position) can be >> ulp(separation)), and df_sqr drops
    # the de^2 term, losing (de/d)^2 relative accuracy on an unnormalized
    # pair (measured: 5.6e-6 -> 8.9e-11 at separation 1e-5 of the
    # coordinate scale after this two_sum).
    d, de = two_sum(src_hi[None, :, :], -rows_hi[:, None, :])
    de = de + (src_lo[None, :, :] - rows_lo[:, None, :])
    d, de = two_sum(d, de)

    # r^2 = sum df_sqr(dx_c) + eps^2
    u = (jnp.zeros(d.shape[:-1], jnp.float32),
         jnp.zeros(d.shape[:-1], jnp.float32))
    for c in range(3):
        u = df_add(u, df_sqr((d[..., c], de[..., c])))
    u = df_add(u, (eps2_hi, eps2_lo))

    inv = df_rsqrt(u)
    if guarded:
        ok = u[0] > 0
        inv = (jnp.where(ok, inv[0], 0.0), jnp.where(ok, inv[1], 0.0))
    gm = (gm_hi[None, :], gm_lo[None, :])
    gminv = df_mul(gm, inv)
    w = df_mul(gminv, df_sqr(inv))                        # gm * inv^3

    acc = jnp.stack(
        [_df_reduce(df_mul(w, (d[..., c], de[..., c]))) for c in range(3)],
        axis=-1)
    out = (acc,)
    if want_phi:
        out = out + (-_df_reduce(gminv),)
    if src_vhi is not None:
        dv, dve = two_sum(src_vhi[None, :, :], -rows_vhi[:, None, :])
        dve = dve + (src_vlo[None, :, :] - rows_vlo[:, None, :])
        dv, dve = two_sum(dv, dve)
        rv = (jnp.zeros_like(u[0]), jnp.zeros_like(u[1]))
        for c in range(3):
            rv = df_add(rv, df_mul((d[..., c], de[..., c]),
                                   (dv[..., c], dve[..., c])))
        # s = 3 rv w inv^2
        s = df_mul(df_mul_f(rv, jnp.float32(3.0)),
                   df_mul(w, df_sqr(inv)))
        jerk = jnp.stack(
            [_df_reduce(df_add(df_mul(w, (dv[..., c], dve[..., c])),
                               df_mul((-s[0], -s[1]),
                                      (d[..., c], de[..., c]))))
             for c in range(3)], axis=-1)
        out = out + (jerk,)
    return out[0] if len(out) == 1 else out


def _df_prepare(pos, mass, eps, G):
    center = jnp.mean(pos, axis=0)
    hi, lo = df_from_f64(pos - center)
    gm_hi, gm_lo = df_from_f64(jnp.asarray(G, jnp.float64) * mass)
    # eps^2 as a df pair: a single-f32 eps^2 (~9e-8 rel) caps the force
    # accuracy of softening-dominated close pairs (measured 1.3e-7)
    eps2_hi, eps2_lo = df_from_f64(jnp.asarray(eps, jnp.float64) ** 2)
    return hi, lo, gm_hi, gm_lo, eps2_hi, eps2_lo


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_df(pos, mass, eps=0.0, G=1.0, chunk: int = 256,
             guarded: bool = True):
    """Full-df32 pairwise accel; f64 in/out. Per-pair error ~1e-10 rel
    (measured vs the f64 oracle incl. close pairs) — the high-accuracy
    tier for validation runs and tight drift budgets."""
    hi, lo, gm_hi, gm_lo, e2h, e2l = _df_prepare(pos, mass, eps, G)
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _df_row_block(sl(hi_p), sl(lo_p), hi, lo, gm_hi, gm_lo,
                             e2h, e2l, guarded)

    return _ext_chunked(n, chunk, block).astype(pos.dtype)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_potential_df(pos, mass, eps=0.0, G=1.0, chunk: int = 256,
                       guarded: bool = True):
    """(accel, phi) full-df32 tier. When eps > 0 phi INCLUDES the
    softened self term -G*m/eps (self pairs have u = eps^2 > 0, so the
    u > 0 guard does not zero them); the caller cancels it by adding
    gravity.self_phi (forces.py does)."""
    hi, lo, gm_hi, gm_lo, e2h, e2l = _df_prepare(pos, mass, eps, G)
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _df_row_block(sl(hi_p), sl(lo_p), hi, lo, gm_hi, gm_lo,
                             e2h, e2l, guarded, want_phi=True)

    acc, phi = _ext_chunked(n, chunk, block)
    return acc.astype(pos.dtype), phi.astype(pos.dtype)


@functools.partial(jax.jit, static_argnames=("chunk", "guarded"))
def accel_jerk_df(pos, vel, mass, eps=0.0, G=1.0, chunk: int = 256,
                  guarded: bool = True):
    """(accel, jerk) full-df32 tier (Hermite force evaluation)."""
    hi, lo, gm_hi, gm_lo, e2h, e2l = _df_prepare(pos, mass, eps, G)
    vcenter = jnp.mean(vel, axis=0)
    vhi, vlo = df_from_f64(vel - vcenter)
    n = pos.shape[0]
    nb = -(-n // chunk)
    hi_p, lo_p = _pad0(hi, nb * chunk), _pad0(lo, nb * chunk)
    vhi_p, vlo_p = _pad0(vhi, nb * chunk), _pad0(vlo, nb * chunk)

    def block(i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        return _df_row_block(sl(hi_p), sl(lo_p), hi, lo, gm_hi, gm_lo,
                             e2h, e2l, guarded, rows_vhi=sl(vhi_p),
                             rows_vlo=sl(vlo_p), src_vhi=vhi,
                             src_vlo=vlo)

    acc, jerk = _ext_chunked(n, chunk, block)
    return acc.astype(pos.dtype), jerk.astype(pos.dtype)
