#!/usr/bin/env python
"""Round-5 VERDICT W2: run the flagship on its own measured medicine.

The round-4 attribution closed the SEV-boundary term; the remaining
9.5e-5 residual's worst interval jumps are ambient block truncation
(r4 series: -5.3e-5 at t=20->21, -4.9e-5 at t=0->1, +3.3e-5 at
t=15->16) — exactly the term bench/postcollapse_envelope.json measured
PEC² cutting ~4x at sub-linear cost. This driver runs controlled
t = 0 -> 21 segments (budget: covers all three top-r4 windows) of configs/flagship_32k.toml (cold start, same
seed — the window contains 3 of the top-4 r4 jumps) under single-knob
stepping variants:

  base    — exact config: must reproduce the r4 jump pattern (control).
  pec2    — integrator.pec2 = true (the envelope-study winner).
  dtmax2  — integrator.dt_max halved (every rung one level deeper).
  both    — pec2 + dtmax2.

Metric: the largest single-interval jump of the ledger-corrected
residual inside the segment + the wall cost, writing
bench/flagship_stepping.json. The winner (error x cost frontier) then
drives the full-length re-run and the committed config update.

Usage: python bench/flagship_stepping.py [--variants base pec2 ...]
       [--t-end 30]
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "base": {},
    "pec2": {"integrator.pec2": "true"},
    "dtmax2": {"integrator.dt_max": "0.03125"},
    "both": {"integrator.pec2": "true", "integrator.dt_max": "0.03125"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--t-end", type=float, default=21.0)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.run import run

    summary = {}
    path = "bench/flagship_stepping.json"
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)          # merge across invocations
    for name in args.variants:
        out_dir = f"out/flag_step_{name}"
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        ov = dict(VARIANTS[name])
        ov.update({
            "output.out_dir": out_dir,
            "output.t_end": str(args.t_end),
            "output.snap_every": "1000.0",
            "output.stdout": "false",
        })
        cfg = apply_overrides(
            load_config("configs/flagship_32k.toml"),
            [f"{k}={v}" for k, v in ov.items()])
        print(f"--- variant {name} ---", flush=True)
        res = run(cfg)
        t = np.asarray(res.diagnostics["time"])
        col = ("dE_cons_over_E_int" if "dE_cons_over_E_int"
               in res.diagnostics else "dE_over_E_int")
        d = np.asarray(res.diagnostics[col])
        dd = np.diff(d)
        i = int(np.argmax(np.abs(dd)))
        summary[name] = {
            "column": col,
            "t_end": float(args.t_end),
            "max_interval_jump": float(dd[i]),
            "t_jump": [float(t[i]), float(t[i + 1])],
            "max_abs_resid": float(np.abs(d).max()),
            "window_total_change": float(d[-1] - d[0]),
            "n_steps": int(res.n_steps),
            "wall_s": float(res.wall_time_s),
        }
        print(name, json.dumps(summary[name]), flush=True)

    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
