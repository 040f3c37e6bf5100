#!/usr/bin/env python
"""Round-5 VERDICT Missing #1: measure the pair-aware rung criterion on
the committed binary-dominated system itself.

configs/binaries_8k.toml under the round-4 prescription (block + 12
rungs + PEC²) still random-walks |dE/E_int| to ~3.5e-3 by t=6.5
(out/binaries_8k, finished round-5): the Aarseth rung criterion is
force-derived and the softened force VANISHES through the core, so
eccentric pairs get under-stepped exactly at pericentre. This driver
runs controlled t = 0 -> 1 segments (2,458 binaries; the t=0.5/1.0 rows
of the committed run measured 3.2e-4 / 6.7e-4 — resolvable signal)
under single-knob variants of the new criterion:

  base    — committed config (control; must reproduce ~6.7e-4 at t=1).
  pair12  — integrator.pair_dt = true, n_levels unchanged (12): the
            criterion can only re-rung within the existing grid
            (dt_min = 7.6e-6 vs the eta_pair·tau demand ~5.5e-6 —
            marginally too shallow by design, measures the grid limit).
  pair13  — pair_dt + n_levels = 13 (dt_min 3.8e-6, one level of
            headroom).
  pair14  — pair_dt + n_levels = 14 (dt_min 1.9e-6, two levels).

Writes bench/binaries_pairdt.json: per-variant max |dE/E_int| over the
segment, rung occupancy tail, micro-step count and wall. The
error-vs-cost winner drives the full t_end=8 evidence re-run and the
committed config update.

Usage: python bench/binaries_pairdt.py [--variants base pair12 ...]
       [--t-end 1.0]
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "base": {},
    "pair12": {"integrator.pair_dt": "true"},
    "pair13": {"integrator.pair_dt": "true", "integrator.n_levels": "13"},
    "pair14": {"integrator.pair_dt": "true", "integrator.n_levels": "14"},
    # f32-noise hypothesis (round-5, after the pair variants measured
    # within the same ~1e-3 envelope): a binary at separation ~eps in
    # unit-scale cluster coordinates carries ~2e-4 RELATIVE f32 error on
    # its internal force — per-eval random kicks on each pair's binding
    # energy, random-walking E_int over ~1e5 micro-steps. The extended
    # (hi/lo) tier cuts pairwise force error ~5-10x at ~2x cost and the
    # block active-row eval supports it (accel_jerk_rows_x).
    "xt": {"integrator.precision": "extended"},
    "pair13xt": {"integrator.pair_dt": "true", "integrator.n_levels": "13",
                 "integrator.precision": "extended"},
    # windowed (pair_r_max = 4 eps, the post-pair12 default) + the depth
    # that worked: the criterion focuses on core transits only
    "pair14w": {"integrator.pair_dt": "true", "integrator.n_levels": "14"},
    "pair14xt": {"integrator.pair_dt": "true", "integrator.n_levels": "14",
                 "integrator.precision": "extended"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--t-end", type=float, default=1.0)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.run import run

    summary = {}
    path = "bench/binaries_pairdt.json"
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    for name in args.variants:
        out_dir = f"out/bin_pairdt_{name}"
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        ov = dict(VARIANTS[name])
        ov.update({
            "output.out_dir": out_dir,
            "output.t_end": str(args.t_end),
            "output.diag_every": "0.25",
            "output.snap_every": "1000.0",
            "output.stdout": "false",
        })
        cfg = apply_overrides(
            load_config("configs/binaries_8k.toml"),
            [f"{k}={v}" for k, v in ov.items()])
        print(f"--- variant {name} ---", flush=True)
        res = run(cfg)
        d = np.asarray(res.diagnostics["dE_over_E_int"])
        occ_tail = {
            k: int(np.asarray(res.diagnostics[k])[-1])
            for k in sorted(res.diagnostics)
            if k.startswith("rung_")
            and np.asarray(res.diagnostics[k])[-1] > 0}
        summary[name] = {
            "t_end": float(args.t_end),
            "max_abs_dE_int": float(np.abs(d).max()),
            "final_dE_int": float(d[-1]),
            "series": [float(x) for x in d],
            "rung_occupancy_final": occ_tail,
            "n_steps": int(res.n_steps),
            "wall_s": float(res.wall_time_s),
        }
        print(name, json.dumps(summary[name]), flush=True)

    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "series"}
                      for k, v in summary.items()}, indent=1))


if __name__ == "__main__":
    main()
