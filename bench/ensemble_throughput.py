#!/usr/bin/env python
"""Ensemble (survey) mode throughput: E vmapped members vs serial runs.

The point of oc_nbody_tpu/ensemble.py: a single small-N realization leaves
the chip idle (dispatch latency >> arithmetic), so E realizations in one
vmapped program should approach E× the serial rate. Measures steps/s for
one member standalone vs an E-member ensemble (same config), slope-timed.

Writes bench/ensemble_throughput.json.
Usage: python bench/ensemble_throughput.py [--n 1024 --es 16 64]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from oc_nbody_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--es", nargs="*", type=int, default=[16, 64, 256])
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (platform is {jax.default_backend()!r})") 0

    import jax.numpy as jnp

    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
    from oc_nbody_tpu.models.plummer import plummer

    n, k = args.n, args.steps
    force = make_force_model(eps=1.0 / 64, backend="jnp",
                             chunk=max(256, n))
    stepper = LeapfrogKDK(force=force, dt=1.0 / 256)

    def timed(adv, carry):
        jax.block_until_ready(adv(carry))
        t0 = time.perf_counter()
        out = adv(carry)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    # serial single member
    st = plummer(n, jax.random.PRNGKey(0))
    c1 = jax.jit(stepper.init)(st)
    adv1 = jax.jit(lambda c: stepper.advance(c, k))
    t1 = timed(adv1, c1)
    rate1 = k / t1
    rows = [{"E": 1, "N": n, "steps_per_s": rate1,
             "member_steps_per_s": rate1, "speedup_vs_serial": 1.0}]
    print(f"E=  1 N={n}  {rate1:9.1f} member-steps/s")

    for e in args.es:
        sts = [plummer(n, jax.random.PRNGKey(i)) for i in range(e)]
        stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *sts)
        ce = jax.jit(jax.vmap(stepper.init))(stacked)
        adve = jax.jit(jax.vmap(lambda c: stepper.advance(c, k)))
        te = timed(adve, ce)
        rate = e * k / te
        rows.append({"E": e, "N": n, "steps_per_s": k / te,
                     "member_steps_per_s": rate,
                     "speedup_vs_serial": rate / rate1})
        print(f"E={e:4d} N={n}  {rate:9.1f} member-steps/s  "
              f"({rate/rate1:5.1f}x serial)")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ensemble_throughput.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
