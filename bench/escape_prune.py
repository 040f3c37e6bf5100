#!/usr/bin/env python
"""Escape-pruning force-eval cost on hardware: full N² sweep vs the pruned
two-sweep evaluation (all rows × cluster bucket + bucket rows × all
sources = 2·B·N interactions) at several bucket sizes.

The partition here is synthetic (innermost stars by radius) — the point is
the KERNEL cost curve, which depends only on shapes. Expected speedup
N²/(2·B·N) = N/(2B): bucket 8192 at N=65536 → ~4×.

Writes bench/escape_prune.json. Usage: python bench/escape_prune.py
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from oc_nbody_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from perf_sweep import timeit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--buckets", nargs="*", type=int,
                    default=[16384, 8192, 4096])
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (platform is {jax.default_backend()!r})") 0

    import numpy as np
    import jax.numpy as jnp

    from oc_nbody_tpu import escape
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer

    n = args.n
    state = plummer(n, jax.random.PRNGKey(0))
    force = make_force_model(eps=1.0 / 256, backend="auto")

    full = jax.jit(lambda p, m: force.accel(p, m))
    t_full = timeit(full, state.pos, state.mass, repeats=args.repeats)
    rows = [{"N": n, "bucket": None, "ms": t_full * 1e3,
             "speedup_vs_full": 1.0}]
    print(f"N={n} full      {t_full*1e3:9.2f} ms")

    r = np.linalg.norm(np.asarray(state.pos), axis=1)
    order = np.argsort(r)
    for b in args.buckets:
        # innermost b stars = the synthetic cluster (exactly fills the
        # bucket: the cost depends on shapes, not membership)
        mask = np.zeros(n, bool)
        mask[order[:b]] = True
        idx, wgt, n_c = escape.build_sources(mask, 64)
        assert idx.shape[0] == b, (idx.shape, b)
        pruned = force.with_sources(jnp.asarray(idx), jnp.asarray(wgt),
                                    jnp.asarray(mask.astype(np.float64)))
        fn = jax.jit(lambda p, m: pruned.accel(p, m))
        t = timeit(fn, state.pos, state.mass, repeats=args.repeats)
        rows.append({"N": n, "bucket": b, "ms": t * 1e3,
                     "speedup_vs_full": t_full / t})
        print(f"N={n} bucket {b:6d} {t*1e3:9.2f} ms  "
              f"{t_full/t:5.2f}x (ideal {n/(2*b):.2f}x)")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "escape_prune.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
