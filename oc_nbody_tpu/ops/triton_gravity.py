"""Pallas kernels (Triton route) for the O(N²) rows-vs-sources sweep.

The GPU form of ``ops.gravity``'s rows-vs-sources primitives, with the same
signatures and contracts (``accel_rows``, ``accel_potential_rows``,
``accel_jerk_rows``; ``chunk`` is accepted and ignored), plus the
single-chip wrappers ``accel``, ``accel_potential`` and ``accel_jerk``.

Design (the textbook direct-summation sweep, GPU Gems 3 ch. 31):

  * Each program owns ``BR`` target rows and keeps their sums in registers
    while it loops over tiles of ``BS`` sources: a (BR, BS) accumulator
    per output, reduced over the tile axis once, after the loop (a row
    reduction per tile measured ~4x slower on the H100). Triton's software
    pipeline (``num_stages``) overlaps the next tile's loads with this
    tile's work.
  * Summation: ``GROUP`` tiles are summed plainly, then added to the
    total with a Kahan step, which holds the per-row error near the
    rounding of one group instead of growing with N. Measured at
    N=1,048,576 on an H100: median per-row accel error 5.7e-8 with it,
    7.6e-7 with one plain sum, 5.8e-8 for XLA; it costs 1.2-1.5x the
    time of the plain sum (bench/kernel_compare.py --sweep, --plain).
  * Rows and sources travel as structure-of-arrays planes (x, y, z[, vx,
    vy, vz], G·m), padded to a whole number of blocks; padded sources carry
    zero mass and padded rows are trimmed. Triton block shapes are powers
    of two, so the (N, 3) layout is split into planes by the wrapper.
  * Plain f32 arithmetic with the hardware rsqrt: no matrix units. The
    |r_i|²+|r_j|²−2r_i·r_j product form loses about four digits to
    cancellation, and TF32 would lose more.
  * Few row blocks (block-step active sets, pruned buckets, mesh shards)
    cannot fill the card, so the sources are then split over a second grid
    axis and the partial sums added outside the kernel (``_n_split``).
  * ``u = r² + eps²`` is guarded, so eps == 0 self pairs give 0: rows may
    overlap sources, as in ``ops.gravity``.

``interpret=True`` runs the same kernels through the Pallas interpreter on
any backend (the CPU tests use it); without it they compile only for the GPU.
"""
from __future__ import annotations

import functools
import importlib
import sys

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from oc_nbody_tpu.ops.gravity import prepare_f32, self_phi

# While a kernel is lowered, MLIR's Python bindings look for a Python
# module of the Triton dialect ("tt") under each of these packages, once
# for every op they build. None exists, and the bindings do not remember
# the miss, so every program that holds a kernel pays ~300 failed imports.
# A None entry in sys.modules makes each lookup fail at once. Measured on
# an H100 host: lowering a program with the three kernels took 0.066 s
# with these entries and 0.351 s without.
DIALECT_LOOKUPS = ("jaxlib.mlir.dialects.tt", "jaxlib.mosaic.python.tt",
                   "jax.jaxlib.mosaic.python.tt")
for _name in DIALECT_LOOKUPS:
    try:
        importlib.import_module(_name)
    except ImportError:
        sys.modules[_name] = None

# (rows per program, sources per tile, warps, pipeline stages) per op,
# the fastest with GROUP of a sweep at N=65,536 on an H100
# (bench/kernel_compare.py --sweep)
TILES = {
    "a": (64, 16, 8, 2),
    "ap": (64, 8, 4, 2),
    "aj": (64, 8, 8, 2),
}
# source tiles summed plainly before each compensated (Kahan) step
GROUP = 16
# below this many row blocks the sources are split over a second grid
# axis: two programs for each of the H100's 132 SMs
MIN_PROGRAMS = 264


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _n_split(n_row_blocks: int, n_tiles: int, min_programs: int):
    """(source splits, tiles per split) so that row blocks × splits reaches
    ``min_programs`` where the source tiles allow it."""
    want = max(1, min(-(-min_programs // n_row_blocks), n_tiles))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _planes(a, n_pad):
    """(m, k) -> k zero-padded (n_pad,) f32 planes."""
    a = a.astype(jnp.float32)
    return [jnp.pad(a[:, c], (0, n_pad - a.shape[0])) for c in range(a.shape[1])]


def _kernel(eps2_ref, *refs, kind, bs, tiles, group):
    n_row = 6 if kind == "aj" else 3
    n_src = n_row + 1
    rows = [r[...][:, None] for r in refs[:n_row]]
    src = refs[n_row:n_row + n_src]
    outs = refs[n_row + n_src:]
    eps2 = eps2_ref[0]
    base = pl.program_id(1) * (tiles * bs)
    br = rows[0].shape[0]

    def terms(t):
        """Tile t's (BR, BS) pair terms, one per output."""
        sl = pl.ds(base + t * bs, bs)
        dx = src[0][sl][None, :] - rows[0]
        dy = src[1][sl][None, :] - rows[1]
        dz = src[2][sl][None, :] - rows[2]
        gm = src[-1][sl][None, :]
        u = dx * dx + dy * dy + dz * dz + eps2
        inv = jnp.where(u > 0, lax.rsqrt(u), 0.0)
        gi = gm * inv
        w = gi * (inv * inv)
        out = [w * dx, w * dy, w * dz]
        if kind == "ap":
            out.append(-gi)
        elif kind == "aj":
            dvx = src[3][sl][None, :] - rows[3]
            dvy = src[4][sl][None, :] - rows[4]
            dvz = src[5][sl][None, :] - rows[5]
            rv = dx * dvx + dy * dvy + dz * dvz
            # s = 3 w rv / u == 3 rv w inv² (inv is already zero-guarded)
            s = (3.0 * rv) * w * (inv * inv)
            out += [w * dvx - s * dx, w * dvy - s * dy, w * dvz - s * dz]
        return out

    zero = jnp.zeros((br, bs), jnp.float32)

    def group_body(g, carry):
        # plain sums over `group` tiles, then one Kahan step into the total
        def tile_body(t, part):
            return tuple(p + c for p, c in zip(part, terms(g * group + t)))

        part = lax.fori_loop(0, group, tile_body, (zero,) * len(outs))
        tot, comp = carry
        y = [p - c for p, c in zip(part, comp)]
        new = [a + b for a, b in zip(tot, y)]
        comp = tuple((n - a) - b for n, a, b in zip(new, tot, y))
        return tuple(new), comp

    tot, comp = lax.fori_loop(0, tiles // group, group_body,
                              ((zero,) * len(outs), (zero,) * len(outs)))
    for o, a, c in zip(outs, tot, comp):
        o[...] = jnp.sum(a - c, axis=1)


_N_OUT = {"a": 3, "ap": 4, "aj": 6}


@functools.partial(jax.jit, static_argnames=("kind", "interpret"))
def _sweep(kind, rows, srcs, gm, eps2, *, interpret=False):
    """Run the ``kind`` kernel: ``rows`` is a list of (nr, 3) arrays (pos[,
    vel]), ``srcs`` the matching (ns, 3) source arrays, ``gm`` the (ns,)
    G·m. Returns ``_N_OUT[kind]`` f32 (nr,) planes. Tiles come from
    ``TILES``, ``GROUP`` and ``MIN_PROGRAMS`` at trace time (a tile sweep
    sets them and calls ``_sweep.clear_cache()``)."""
    br, bs, warps, stages = TILES[kind]
    nr, ns = rows[0].shape[0], srcs[0].shape[0]
    nrp = _round_up(max(nr, 1), br)
    n_row_blocks = nrp // br
    n_split, tiles = _n_split(n_row_blocks, -(-max(ns, 1) // bs),
                              MIN_PROGRAMS)
    group = min(GROUP, tiles)
    tiles = _round_up(tiles, group)
    nsp = n_split * tiles * bs
    with jax.enable_x64(False):
        row_planes = [p for r in rows for p in _planes(r, nrp)]
        src_planes = [p for s in srcs for p in _planes(s, nsp)]
        src_planes.append(jnp.pad(gm.astype(jnp.float32), (0, nsp - ns)))
        n_out = _N_OUT[kind]
        outs = pl.pallas_call(
            functools.partial(_kernel, kind=kind, bs=bs, tiles=tiles,
                              group=group),
            out_shape=[jax.ShapeDtypeStruct((n_split, nrp), jnp.float32)]
            * n_out,
            grid=(n_row_blocks, n_split),
            in_specs=[pl.BlockSpec((1,), lambda i, k: (0,))]
            + [pl.BlockSpec((br,), lambda i, k: (i,))] * len(row_planes)
            + [pl.BlockSpec((nsp,), lambda i, k: (0,))] * len(src_planes),
            out_specs=[pl.BlockSpec((None, br), lambda i, k: (k, i))] * n_out,
            compiler_params=plgpu.CompilerParams(num_warps=warps,
                                                 num_stages=stages),
            backend="triton",
            interpret=interpret,
            name=f"gravity_rows_{kind}",
        )(jnp.reshape(eps2.astype(jnp.float32), (1,)), *row_planes,
          *src_planes)
        return [jnp.sum(o, axis=0)[:nr] for o in outs]


def _gm(G, src_mass):
    return jnp.asarray(G, jnp.float32) * jnp.asarray(src_mass, jnp.float32)


def _eps2(eps):
    return jnp.asarray(eps, jnp.float32) ** 2


def accel_rows(pos_rows, src_pos, src_mass, eps, G=1.0, chunk=None, *,
               interpret=False):
    """Accel on ``pos_rows`` from ``src_pos``/``src_mass`` (centred, f32)."""
    ax, ay, az = _sweep("a", [pos_rows], [src_pos], _gm(G, src_mass),
                        _eps2(eps), interpret=interpret)
    return jnp.stack([ax, ay, az], axis=1)


def accel_potential_rows(pos_rows, src_pos, src_mass, eps, G=1.0, chunk=None,
                         *, interpret=False):
    """(accel, phi) on rows; phi still holds the softened self term where
    rows overlap sources — the caller adds ``self_phi``."""
    ax, ay, az, phi = _sweep("ap", [pos_rows], [src_pos], _gm(G, src_mass),
                             _eps2(eps), interpret=interpret)
    return jnp.stack([ax, ay, az], axis=1), phi


def accel_jerk_rows(pos_rows, vel_rows, src_pos, src_vel, src_mass, eps,
                    G=1.0, chunk=None, *, interpret=False):
    """(accel, jerk) on rows from sources."""
    out = _sweep("aj", [pos_rows, vel_rows], [src_pos, src_vel],
                 _gm(G, src_mass), _eps2(eps), interpret=interpret)
    return jnp.stack(out[:3], axis=1), jnp.stack(out[3:], axis=1)


# --------------------------------------------------------------------------
# single-chip wrappers (same API as ops.gravity): centre -> f32 -> rows ==
# sources -> cast back
# --------------------------------------------------------------------------

def accel(pos, mass, eps=0.0, G=1.0, *, chunk=None, interpret=False):
    pos_c, mass_c = prepare_f32(pos, mass)
    return accel_rows(pos_c, pos_c, mass_c, eps, G,
                      interpret=interpret).astype(pos.dtype)


def accel_potential(pos, mass, eps=0.0, G=1.0, *, chunk=None,
                    interpret=False):
    pos_c, mass_c = prepare_f32(pos, mass)
    acc, phi = accel_potential_rows(pos_c, pos_c, mass_c, eps, G,
                                    interpret=interpret)
    phi = phi + self_phi(mass_c, jnp.asarray(eps, jnp.float32),
                         jnp.asarray(G, jnp.float32))
    return acc.astype(pos.dtype), phi.astype(pos.dtype)


def accel_jerk(pos, vel, mass, eps=0.0, G=1.0, *, chunk=None,
               interpret=False):
    pos_c, mass_c, vel_c = prepare_f32(pos, mass, vel=vel)
    acc, jerk = accel_jerk_rows(pos_c, vel_c, pos_c, vel_c, mass_c, eps, G,
                                interpret=interpret)
    return acc.astype(pos.dtype), jerk.astype(pos.dtype)
