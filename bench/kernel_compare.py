#!/usr/bin/env python
"""Pairwise sweep on the GPU: the Pallas (Triton) kernels against XLA's
compile of ``ops/gravity.py``, per op, with errors against the f64
reference.

For each N and op (accel ``a``, accel+phi ``ap``, accel+jerk ``aj``) it
prints one JSON line: per-eval device time of each backend (dependent
chain, block_until_ready), pair interactions/s, and the per-row relative
error |a - a_ref|/|a_ref| (max and median) of each backend on the first
``--check-rows`` rows against all N sources, the reference computed on the
card in float64 under "highest" matmul precision. ``--plain`` runs the
kernels without compensated steps (one plain sum over all source tiles).
``--sweep N`` instead times and checks the kernels' tile choices at N,
each with and without compensation. ``--shapes RxS ...`` times the
rows-vs-sources ops (accel, accel+jerk) of both backends on R rows against
S sources: block-step active sets, pruned buckets. Needs a GPU; exits
non-zero without one.

    python bench/kernel_compare.py --ns 16384 65536 1048576
    python bench/kernel_compare.py --sweep 65536
    python bench/kernel_compare.py --shapes 8x32768 512x32768 65536x16384
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from oc_nbody_tpu.models.plummer import plummer  # noqa: E402
from oc_nbody_tpu.ops import gravity, triton_gravity  # noqa: E402

EPS = 1.0 / 512
# a GROUP no tile count reaches: one plain sum, no compensated step
PLAIN = 1 << 30


def set_tiles(kind, tiles=None, group=None):
    """Set the kernels' tile constants for ``kind`` and drop their traces."""
    if tiles is not None:
        triton_gravity.TILES[kind] = tiles
    if group is not None:
        triton_gravity.GROUP = group
    triton_gravity._sweep.clear_cache()


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def timeit(fn, pos, repeats):
    """Per-eval seconds of ``fn(pos)`` from a dependent chain's slope."""
    @jax.jit
    def chain(p, k):
        def body(_, p):
            leaves = jax.tree_util.tree_leaves(fn(p))
            a = sum(jnp.sum(x).astype(p.dtype) for x in leaves)
            return p + jnp.asarray(1e-30, p.dtype) * a
        return jax.lax.fori_loop(0, k, body, p)

    chain(pos, 1).block_until_ready()
    t0 = time.perf_counter()
    chain(pos, 1).block_until_ready()
    t1 = time.perf_counter()
    chain(pos, 1 + repeats).block_until_ready()
    t2 = time.perf_counter()
    return max(((t2 - t1) - (t1 - t0)) / repeats, 1e-9)


def rel_err(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if ref.ndim == 1:
        e = np.abs(x - ref) / np.abs(ref)
    else:
        e = np.linalg.norm(x - ref, axis=1) / np.linalg.norm(ref, axis=1)
    return float(np.max(e)), float(np.median(e))


def ops(kind, mod, **kw):
    """Single-chip op of ``kind`` from ``mod`` as f(pos, vel, mass)."""
    if kind == "a":
        return lambda p, v, m: mod.accel(p, m, EPS, **kw)
    if kind == "ap":
        return lambda p, v, m: mod.accel_potential(p, m, EPS, **kw)
    return lambda p, v, m: mod.accel_jerk(p, v, m, EPS, **kw)


def reference(kind, pos, vel, mass, rows):
    """f64 rows-vs-all-sources reference for the first ``rows`` rows."""
    f64 = jnp.float64
    pc, mc, vc = gravity.prepare_f32(pos, mass, vel=vel, compute_dtype=f64)
    with jax.default_matmul_precision("highest"):
        if kind == "a":
            return (gravity.accel_rows(pc[:rows], pc, mc, EPS, 1.0, 256),)
        if kind == "ap":
            a, p = gravity.accel_potential_rows(pc[:rows], pc, mc, EPS, 1.0,
                                                256)
            return a, p + gravity.self_phi(mc[:rows], f64(EPS), f64(1.0))
        return gravity.accel_jerk_rows(pc[:rows], vc[:rows], pc, vc, mc, EPS,
                                       1.0, 256)


def compare(n, check_rows, repeats, backends=("pallas", "xla"), time=True):
    state = plummer(n, jax.random.PRNGKey(0))
    pos, vel, mass = state.pos, state.vel, state.mass
    mods = {"pallas": triton_gravity, "xla": gravity}
    for kind in ("a", "ap", "aj"):
        ref = jax.jit(reference, static_argnums=(0, 4))(kind, pos, vel,
                                                          mass, check_rows)
        row = {"N": n, "op": kind, "card": card(),
               "device_kind": jax.devices()[0].device_kind,
               "tiles": triton_gravity.TILES[kind],
               "group": ("plain" if triton_gravity.GROUP == PLAIN
                         else triton_gravity.GROUP)}
        for name in backends:
            f = jax.jit(ops(kind, mods[name]))
            out = f(pos, vel, mass)
            out = out if isinstance(out, tuple) else (out,)
            row[name] = {"err_max_median": [rel_err(o[:check_rows], r)
                                            for o, r in zip(out, ref)]}
            if time:
                reps = repeats if n <= 131072 else 2
                dt = timeit(lambda p: f(p, vel, mass), pos, reps)
                row[name].update(s_per_eval=dt, pairs_per_s=n * n / dt)
        if time and len(backends) == 2:
            row["speedup"] = (row["xla"]["s_per_eval"]
                              / row["pallas"]["s_per_eval"])
        print(json.dumps(row), flush=True)


def sweep(n, repeats, check_rows):
    """{op: {group: (s, tiles)}}: the fastest tiles of each op at N, with
    compensation every GROUP tiles and without ("plain")."""
    state = plummer(n, jax.random.PRNGKey(0))
    pos, vel, mass = state.pos, state.vel, state.mass
    group0 = triton_gravity.GROUP
    bests = {}
    for kind in ("a", "ap", "aj"):
        tiles0 = triton_gravity.TILES[kind]
        ref = jax.jit(reference, static_argnums=(0, 4))(kind, pos, vel,
                                                          mass, check_rows)
        best = {}
        for br, bs, nw, g in itertools.product(
                (64, 128), (8, 16, 32), (4, 8), (group0, PLAIN)):
            tiles = (br, bs, nw, 2)
            set_tiles(kind, tiles, g)
            row = {"N": n, "op": kind, "tiles": tiles,
                   "group": "plain" if g == PLAIN else g}
            try:
                f = jax.jit(ops(kind, triton_gravity))
                out = f(pos, vel, mass)
                dt = timeit(lambda p: f(p, vel, mass), pos, repeats)
            except Exception as e:  # a tile the compiler refuses
                print(json.dumps({**row, "error": str(e)[:200]}), flush=True)
                continue
            out = out if isinstance(out, tuple) else (out,)
            row["s_per_eval"] = dt
            row["err_max_median"] = [rel_err(o[:check_rows], r)
                                     for o, r in zip(out, ref)]
            print(json.dumps(row), flush=True)
            if row["group"] not in best or dt < best[row["group"]][0]:
                best[row["group"]] = (dt, tiles)
        print(json.dumps({"N": n, "op": kind, "best": best}), flush=True)
        set_tiles(kind, tiles0, group0)
        bests[kind] = best
    return bests


def rows_ops(kind, mod):
    """Rows-vs-sources op of ``kind`` as f(rows, vrows, src, vsrc, mass)."""
    if kind == "a":
        return lambda r, vr, s, vs, m: mod.accel_rows(r, s, m, EPS)
    return lambda r, vr, s, vs, m: mod.accel_jerk_rows(r, vr, s, vs, m, EPS)


def shapes(specs, repeats):
    """Per-eval time of each backend's rows-vs-sources op on R rows (the
    first R of a Plummer sphere) against S sources, timed in turns P X X P
    (both readings of each backend are printed)."""
    for spec in specs:
        nr, ns = (int(x) for x in spec.split("x"))
        state = plummer(max(nr, ns), jax.random.PRNGKey(0))
        f32 = jnp.float32
        pos, vel = state.pos.astype(f32), state.vel.astype(f32)
        mass = state.mass.astype(f32)
        for kind in ("a", "aj"):
            row = {"rows": nr, "sources": ns, "op": kind, "card": card(),
                   "pallas": [], "xla": []}
            fns = {}
            for name, mod in (("pallas", triton_gravity), ("xla", gravity)):
                fn = rows_ops(kind, mod)
                fns[name] = jax.jit(lambda p, fn=fn: fn(
                    p[:nr], vel[:nr], p[:ns], vel[:ns], mass[:ns]))
            for name in ("pallas", "xla", "xla", "pallas"):
                row[name].append(timeit(fns[name], pos, repeats))
            row["xla_over_pallas"] = sum(row["xla"]) / sum(row["pallas"])
            print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", type=int, nargs="*", default=[16384, 65536])
    ap.add_argument("--check-rows", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--plain", action="store_true",
                    help="kernels without compensated steps")
    ap.add_argument("--backends", nargs="+", default=["pallas", "xla"],
                    choices=["pallas", "xla"])
    ap.add_argument("--no-time", action="store_true",
                    help="errors only")
    ap.add_argument("--sweep", type=int, default=0, metavar="N")
    ap.add_argument("--shapes", nargs="*", default=[], metavar="RxS")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_compare: no GPU found "
                 f"(platform {jax.devices()[0].platform!r})")
    if args.sweep:
        sweep(args.sweep, args.repeats, args.check_rows)
        return
    if args.shapes:
        shapes(args.shapes, args.repeats)
        return
    if args.plain:
        set_tiles("a", group=PLAIN)
    for n in args.ns:
        compare(n, min(args.check_rows, n), args.repeats, args.backends,
                not args.no_time)


if __name__ == "__main__":
    main()
