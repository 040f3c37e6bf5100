#!/usr/bin/env python
"""Per-step integrator cost at the production north-star point (N=65,536,
KDK + analytic MW field — BASELINE.json:5), for each in-jit stepper kind.

Answers "what does a step of each integrator cost?" with one protocol:
slope-timed dependent chains of the ACTUAL driver-built stepper
(build_scene + make_stepper from the committed config, so the numbers
include the O(N) f64 integration arithmetic and the external field, not
just the pairwise kernel). Expected shape: yoshida4 ~= 3x kdk (3 force
evals/step), hermite ~= 1 accel+jerk eval + corrector.

Writes bench/integrator_cost.json.
Usage: python bench/integrator_cost.py [--kinds kdk yoshida4 hermite]
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", nargs="*",
                    default=["kdk", "yoshida4", "hermite"])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "north_star_65k_orbit.toml"))
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (platform is {jax.default_backend()!r})") 0

    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.scene import build_scene, make_stepper

    base = load_config(args.config)
    rows = []
    for kind in args.kinds:
        cfg = apply_overrides(base, [f"integrator.kind={kind}"])
        scene = build_scene(cfg)
        stepper, _ = make_stepper(cfg, scene.force)
        carry = jax.jit(stepper.init)(scene.state)
        adv = jax.jit(stepper.advance, static_argnums=1)

        jax.block_until_ready(adv(carry, 1))       # compile n=1
        t0 = time.perf_counter()
        jax.block_until_ready(adv(carry, 1))
        t1 = time.perf_counter()
        jax.block_until_ready(adv(carry, 1 + args.repeats))  # compiles once
        # re-dispatch the compiled n=1+repeats program for the timed leg
        t2 = time.perf_counter()
        jax.block_until_ready(adv(carry, 1 + args.repeats))
        t3 = time.perf_counter()
        ms = ((t3 - t2) - (t1 - t0)) / args.repeats * 1e3
        row = {"kind": kind, "N": int(scene.state.pos.shape[0]),
               "ms_per_step": ms}
        rows.append(row)
        print(json.dumps(row))

    out = os.path.join(REPO, "bench", "integrator_cost.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
