#!/usr/bin/env python
"""Escape pruning x macro at N = 1M ON THE CHIP (VERDICT round-3 item 1
"done when"): drive configs/c10p_1m_macro_prune.toml through the standard
run() driver with pruning ON and OFF, and measure the steady per-step
cost of each from the diagnostics wall clock (intervals after the first,
so compile/dispatch-ladder warmup is excluded).

The config is a deliberately super-tidal 1M dissolution (bucket ~ N/16 at
t=0), so the expected force-eval ratio is (N^2/2) / (2 B N) ~ 4x; the
driver-level number also carries the per-interval diagnostics pass and
re-partition, which is the honest end-to-end figure.

Writes bench/prune_scale.json. Usage: python bench/prune_scale.py
[--t-end 0.125]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def seg_cost(res, dt):
    """(s_per_step, n_steps_counted) from post-warmup diagnostics rows."""
    import numpy as np
    w = np.asarray(res.diagnostics["wall_s"])
    t = np.asarray(res.diagnostics["time"])
    if len(w) < 3:
        raise SystemExit("need >= 3 diagnostics rows for a steady measure")
    steps = np.round(np.diff(t) / dt).astype(int)
    # skip the first interval (compile + ladder probe)
    wall = w[-1] - w[1]
    n = int(steps[1:].sum())
    return wall / n, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-end", type=float, default=0.125)
    ap.add_argument("--config", default="configs/c10p_1m_macro_prune.toml")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.run import run

    out = {}
    for name, overrides in (
        ("pruned", ["output.out_dir=out/c10p_1m"]),
        ("full", ["escape.prune=false", "output.out_dir=out/c10p_1m_ctl"]),
    ):
        cfg = apply_overrides(load_config(args.config), overrides + [
            f"output.t_end={args.t_end}", "output.stdout=true"])
        print(f"--- {name} ---", flush=True)
        res = run(cfg)
        sps, n = seg_cost(res, cfg.integrator.dt)
        row = {"s_per_step": sps, "steps_counted": n,
               "wall_s": res.wall_time_s, "n_steps": res.n_steps}
        if name == "pruned":
            row["N_cluster_final"] = float(
                res.diagnostics["N_cluster"][-1])
            row["dE_cons_max"] = float(np.abs(
                res.diagnostics["dE_cons_over_E_int"]).max())
        out[name] = row
        print(name, json.dumps(row), flush=True)

    out["speedup"] = out["full"]["s_per_step"] / out["pruned"]["s_per_step"]
    out["n"] = 1048576
    with open("bench/prune_scale.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
