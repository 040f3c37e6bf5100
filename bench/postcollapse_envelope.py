#!/usr/bin/env python
"""Post-collapse (binary-dominated) stepping envelope — VERDICT round-3
Missing #4: measure the |dE/E|-vs-cost frontier of the available
stepping knobs on the phase that exceeded the pilot's design envelope
(the n=256 core-collapse run degraded to |dE/E| = 0.14 by t=240 after
the bounce at t ~= 106; RESULTS.md round-3).

Stage 1 (once): integrate the committed cc_collapse_1k.toml at n=256
through the bounce to t=110 with the pilot's own 10-rung block setup and
keep the state (out/cc_env/base_state.npz-equivalent via the driver's
snapshots).

Stage 2: from that SAME post-bounce state, integrate a fixed window
(default 30 time units ~= 4 t_rh) under each variant with a FRESH
stepper init (identical startup treatment for every variant — resume
would refuse integrator-kind changes), and record max |dE/E| over the
window plus wall time and step count:

  block10            — the pilot baseline (degrades)
  block12 / block14  — the brute-rung axis (the full-scale config's
                       mitigation)
  block12_pec2       — second corrector pass on the active rows
  hermite_pec2       — shared adaptive dt (the binary sets dt for ALL
                       rows — the cost frontier shows exactly what that
                       costs at n=256)
  hermite_pec2_sym   — + time-symmetrized dt selection
                       (integrator.symmetrized; Hut-Makino-McMillan)

CPU-runnable (n=256, jnp kernels); relative cost is hardware-independent
at fixed arithmetic. Writes bench/postcollapse_envelope.json.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# CPU by design: n=256 jnp kernels, no device needed
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-base", type=float, default=110.0)
    ap.add_argument("--window", type=float, default=30.0)
    ap.add_argument("--variants", nargs="*", default=[
        "block10", "block12", "block14", "block12_pec2",
        "hermite_pec2", "hermite_pec2_sym"])
    # measured: the unbounded sym variant ran >10x hermite_pec2's wall
    # without finishing the window — the symmetrizing fixed point halves
    # the shared dt in the binary-dominated core. Bound it so the partial
    # datum (t_reached, n_steps at the cap) records that cost.
    ap.add_argument("--cap", type=int, default=4_000_000)
    args = ap.parse_args()

    import numpy as np
    from oc_nbody_tpu import diagnostics as diag
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.io.snapshot import latest_snapshot, read_snapshot
    from oc_nbody_tpu.run import run
    from oc_nbody_tpu.scene import build_scene
    from oc_nbody_tpu.integrators.block import BlockHermite
    from oc_nbody_tpu.integrators.hermite import Hermite4

    base_dir = "out/cc_env_base"
    cfg = apply_overrides(load_config("configs/cc_collapse_1k.toml"), [
        "ic.n=256", "integrator.n_levels=10",
        f"output.t_end={args.t_base}", "output.diag_every=2.0",
        f"output.snap_every={args.t_base}", f"output.out_dir={base_dir}",
        "output.stdout=true",
    ])
    snap = latest_snapshot(base_dir)
    if snap is None:
        print("--- stage 1: building the post-bounce base state ---",
              flush=True)
        run(cfg)
        snap = latest_snapshot(base_dir)
    state = read_snapshot(snap).state
    print(f"base state: t={float(state.time):.1f} from {snap}", flush=True)

    scene = build_scene(cfg)          # for the force model (eps, G)
    force = scene.force

    def energy(s):
        return float(jax.device_get(diag.energies(s, force)["E_tot"]))

    e0 = energy(state)
    t_end = float(state.time) + args.window

    def make(variant):
        common = dict(force=force, eta=cfg.integrator.eta,
                      eta_init=cfg.integrator.eta_init,
                      dt_max=cfg.integrator.dt_max)
        if variant.startswith("block"):
            levels = int(variant.replace("block", "").split("_")[0])
            return BlockHermite(n_levels=levels,
                                pec2=variant.endswith("_pec2"), **common)
        return Hermite4(pec2=True, quantize=True,
                        symmetrized=variant.endswith("_sym"), **common)

    out = {"t_base": float(state.time), "window": args.window, "n": 256}
    if os.path.exists("bench/postcollapse_envelope.json"):
        with open("bench/postcollapse_envelope.json") as f:
            prev = json.load(f)
        if (prev.get("t_base") == out["t_base"]
                and prev.get("window") == out["window"]):
            out = prev                  # merge across invocations
    for v in args.variants:
        st = make(v)
        carry = st.init(state)
        jax.block_until_ready(carry.state.pos)
        tic = time.perf_counter()
        adv = jax.jit(st.advance_to_bounded, static_argnums=2)
        # step bailout: the shared-dt hermite variants can need ~binary-
        # period steps for EVERY star — if the cap binds, the partial
        # window + extrapolation IS the frontier datum (the cost is the
        # finding)
        cap = args.cap
        while not st.reached(carry, t_end) and int(carry.n_steps) < cap:
            carry = adv(carry, t_end, 250_000)
        jax.block_until_ready(carry.state.pos)
        wall = time.perf_counter() - tic
        e1 = energy(carry.state)
        t1 = float(carry.state.time)
        row = {"dE_over_E": (e1 - e0) / abs(e0),
               "n_steps": int(carry.n_steps), "wall_s": wall,
               "t_reached": t1,
               "window_done": bool(st.reached(carry, t_end))}
        out[v] = row
        print(v, json.dumps(row), flush=True)

    with open("bench/postcollapse_envelope.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
