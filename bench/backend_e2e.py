#!/usr/bin/env python
"""End to end through the CLI with each pairwise backend, on the GPU.

Runs one fixed-step config through ``python -m oc_nbody_tpu run`` (called
in-process, as ``chip_smoke.py`` does) with ``backend=pallas`` (the Triton
kernels) and ``backend=jnp`` (XLA's compile of ``ops/gravity.py``). One
unmeasured warm-up run of each backend comes first; then the measured runs
alternate P J J P P J ... so that drift of the card's clocks falls on both
sides. Each run prints its wall time and max |dE/E_int|; the last line
gives each backend's median wall. ``--phase3`` times phase 3 of
``chip_smoke.py`` instead (north_star_65k_orbit: 32 steps straight, then
16 + 16 with a resume, checked bitwise). Needs a GPU; exits non-zero
without one.

    python bench/backend_e2e.py                          # north_star, 256 steps
    python bench/backend_e2e.py --steps 32 --runs 3
    python bench/backend_e2e.py --phase3
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402


def run(config, backend, steps, diag_steps, dt):
    """(wall seconds, max |dE/E_int|) of one straight run."""
    path = cs.fresh_dir(f"backend_e2e_{backend}")
    wall = cs.cli(config, path, f"backend={backend}",
                  f"output.t_end={steps * dt!r}",
                  f"output.diag_every={diag_steps * dt!r}",
                  f"output.snap_every={steps * dt!r}")
    _, diag = cs.final_state(path)
    return wall, max(abs(x) for x in diag["dE_over_E_int"])


def run_phase3(backend):
    """(wall seconds, max |dE/E_int|) of chip_smoke's phase 3."""
    t0 = time.perf_counter()
    _, de = cs.phase_north_star(backend=backend)
    return time.perf_counter() - t0, float(de.max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="north_star_65k_orbit.toml")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--diag-steps", type=int, default=64)
    ap.add_argument("--runs", type=int, default=5,
                    help="measured runs of each backend")
    ap.add_argument("--phase3", action="store_true",
                    help="time chip_smoke.py's phase 3 instead")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit("backend_e2e: no GPU found "
                 f"(platform {jax.devices()[0].platform!r})")
    from oc_nbody_tpu.config import load_config
    dt = load_config(os.path.join(HERE, "configs", args.config)).integrator.dt
    card = cs.card_lines()[0]
    what = ("chip_smoke phase 3" if args.phase3
            else f"{args.config}, {args.steps} steps")
    walls = {"pallas": [], "jnp": []}
    order = ["pallas", "jnp"] + [("pallas", "jnp", "jnp", "pallas")[i % 4]
                                 for i in range(2 * args.runs)]
    for i, backend in enumerate(order):
        if args.phase3:
            wall, de = run_phase3(backend)
        else:
            wall, de = run(args.config, backend, args.steps,
                           args.diag_steps, dt)
        measured = i >= 2
        if measured:
            walls[backend].append(wall)
        print(json.dumps({"run": what, "backend": backend,
                          "measured": measured, "wall_s": wall,
                          "max_abs_dE_over_E_int": de, "card": card}),
              flush=True)
    print(json.dumps({"run": what, "card": card, "runs": args.runs,
                      **{f"median_wall_s_{k}": statistics.median(v)
                         for k, v in walls.items()}}), flush=True)


if __name__ == "__main__":
    main()
