#!/usr/bin/env python
"""W2 experiment: what drives c4's 7.3e-5 peak |dE/E_int| transient?

Round-2 VERDICT W2: the flagship eccentric config (c4, block timesteps,
32k, disk-crossing orbit) shows a 7.3e-5 peak excursion in dE/E_int at
t~17 (a pericentre/disk crossing), ~73x the per-crossing target, which
RESULTS.md calls reversible but never isolated. This driver re-runs the
t=16->22 segment from the committed round-2 snapshot under controlled
variants, all cold-started from the same state:

  base      — the committed configuration (reproduces the excursion)
  extended  — integrator.precision=extended (is it f32 force noise?)
  dt4       — dt_max/4 (is it integrator truncation?)
  pec2      — second corrector pass on active rows (corrector error?)

Writes out/c4_seg_<name>/ per variant and prints a peak/final summary ->
paste into RESULTS.md ("c4 transient isolated").

Usage: python bench/c4_transient.py [--variants base extended dt4 pec2]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SNAP = "out/c4_r2s3/snapshot_00002.npz"   # t = 16.0, just before the crossing
T_END = 22.0

VARIANTS = {
    "base": {},
    "extended": {"integrator.precision": "extended"},
    "dt4": {"integrator.dt_max": "0.015625"},          # 1/64 (was 1/16)
    "pec2": {"integrator.pec2": "true"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.run import run

    summary = {}
    for name in args.variants:
        ov = dict(VARIANTS[name])
        ov.update({
            "ic.kind": "file", "ic.file": SNAP,
            "orbit.kind": "none",                  # state is already placed
            "output.out_dir": f"out/c4_seg_{name}",
            "output.t_end": str(T_END),
            "output.diag_every": "0.25",
            "output.snap_every": "1000.0",
            "output.stdout": "false",
        })
        cfg = apply_overrides(
            load_config("configs/c4_block_32k_eccentric.toml"),
            [f"{k}={v}" for k, v in ov.items()])
        print(f"--- variant {name} ---", flush=True)
        res = run(cfg)
        t = np.asarray(res.diagnostics["time"])
        d = np.asarray(res.diagnostics["dE_over_E_int"])
        i = int(np.argmax(np.abs(d)))
        summary[name] = {
            "peak_dE_over_E_int": float(d[i]), "t_peak": float(t[i]),
            "final_dE_over_E_int": float(d[-1]),
            "n_steps": int(res.n_steps),
            "wall_s": float(res.wall_time_s),
        }
        print(name, json.dumps(summary[name]), flush=True)

    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
