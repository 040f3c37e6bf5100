#!/usr/bin/env python
"""Hardware cost of the diagnostics pass at production N (ROADMAP
"structure-diag cost measurement at 65k+").

Measures, slope-timed in one jit each:
  * force-only accel eval (the advance-phase unit of cost),
  * compute_all WITHOUT the CH85 core sweep (core=False),
  * compute_all WITH it (core=True, the default) — the structure columns'
    marginal price is the delta. The CH85 sweep is a second bounded
    O(min(N, 65536)²) distance pass (diagnostics.py local_density caps
    probes AND sources at 65536), so its cost saturates above 65k while
    the potential pass keeps growing as N². Measured on the chip: the
    original lax.top_k form cost a flat 5.45 s per row; the threshold-pass
    kth-NN replacement is ~43-47 ms (126x).

Writes bench/diag_cost.json. Usage: python bench/diag_cost.py [--ns ...]
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
    ap.add_argument("--ns", nargs="*", type=int, default=[65536, 131072])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (platform is {jax.default_backend()!r})") 0

    import dataclasses

    from oc_nbody_tpu import diagnostics
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer

    eps = 1.0 / 256
    rows = []
    for n in args.ns:
        state = plummer(n, jax.random.PRNGKey(0))
        force = make_force_model(eps, backend="auto")

        # timeit chains on args[0] (pos); rebuild the state around it so
        # each evaluation depends on the previous output
        def accel(pos):
            return force.accel(pos, state.mass)

        def diag_nocore(pos):
            s = dataclasses.replace(state, pos=pos)
            return diagnostics.compute_all(s, force, core=False)

        def diag_core(pos):
            s = dataclasses.replace(state, pos=pos)
            return diagnostics.compute_all(s, force, core=True)

        row = {"N": n}
        for name, fn in [("accel_ms", accel), ("diag_nocore_ms", diag_nocore),
                         ("diag_core_ms", diag_core)]:
            row[name] = timeit(fn, state.pos, repeats=args.repeats) * 1e3
        row["core_marginal_ms"] = row["diag_core_ms"] - row["diag_nocore_ms"]
        rows.append(row)
        print(json.dumps(row))

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "diag_cost.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
