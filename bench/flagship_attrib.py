#!/usr/bin/env python
"""Round-3 VERDICT W1: attribute the flagship's 1.1e-3 ledger residual.

The committed flagship run (configs/flagship_32k.toml, RESULTS.md) closes
its energy budget to max |E_tot − E_sev_cum|/E_int(0) = 1.117e-3, and the
diagnostics table shows the residual is ONE event: a +1.06e-3 jump in the
single interval t = 54 → 55 (five remnant formations, E_sev_cum +8.3),
riding on a ±2e-4 background. This driver re-runs the t = 50 → 65 window
from the committed snapshot_00005 (t = 50) under controlled single-knob
variants, each as a genuine --resume (the bench/c4_transient.py
methodology, upgraded: resume keeps the block rungs AND rebuilds the SEV
death schedule from the fresh IC config, so the base variant is a
bit-faithful replay — a cold ic.kind="file" start would rebuild the
schedule from the already-wound t=50 masses and shift every death time):

  base    — exact replay: must reproduce the +1.06e-3 jump (methodology
            control).
  nokick  — sev.kick_sigma_{ns,bh}_kms = 0: same deaths, same mass drops,
            no velocity kicks. Jump gone => kick-energy bookkeeping or
            post-kick integration error.
  nosev   — sev.kind = "none": no deaths at all in the window (masses
            frozen at their t=50 values). Jump persists => pure dynamics
            (hard-binary activity), nothing SEV.
  eta2    — integrator.eta halved (0.01): every Aarseth rung one level
            deeper where the criterion binds. Jump shrinks ~4x =>
            block-integrator truncation (the dt knob that resumes cleanly;
            dt_max/2 would change the integer block grid, which restore
            correctly refuses).

Metric: the largest single-interval jump of the ledger-corrected residual
(dE_cons_over_E_int where tracked, else dE_over_E_int) inside the window,
plus its t and the window-total change. Offsets differ across variants
(nosev has no ledger); interval DIFFS are the comparable quantity.

Usage: python bench/flagship_attrib.py [--variants base nokick nosev eta2]
Writes out/flag_attrib_<name>/ per variant and bench/flagship_attrib.json.
"""
import argparse
import glob
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC_DIR = "out/flagship_32k"
RESUME_SNAP = 5            # snapshot_00005.npz = t 50.0
T_END = 65.0

VARIANTS = {
    "base": {},
    "nokick": {"sev.kick_sigma_ns_kms": "0.0", "sev.kick_sigma_bh_kms": "0.0"},
    "nosev": {"sev.kind": "none"},
    "eta2": {"integrator.eta": "0.01"},
    # round-4 follow-up: base==nokick bitwise and eta2 unchanged, so the
    # residual is SEV-specific but NOT Aarseth-criterion truncation. The
    # remaining dt knob the SEV boundary actually exercises is eta_init:
    # _reinit after each mass drop RESETS the rungs from the eta_init
    # startup rule (run.py), so the post-death transient integrates on
    # eta_init-derived steps that eta does not control.
    "etai2": {"integrator.eta_init": "0.005"},
    # and the accounting-side check: diag_f64 swaps the f32 pairwise phi
    # for emulated-f64 in every E_tot the ledger reads — if the jump
    # shrinks, the residual was measurement noise of the f32 potential
    # at the jump boundaries, not dynamics
    "diagf64": {"output.diag_f64": "true"},
    # validation of the shipped fix (run._merge_reinit_carry): identical
    # knobs to "base", recorded under its own name — at HEAD the SEV
    # boundary caps the re-derived startup rungs by the pre-jump ones,
    # so this replay must land near the etai2 background (~1e-5), not
    # reproduce the +9.0e-4 jump
    "fixed": {},
}


def _prep_dir(name: str) -> str:
    """Copy the committed run dir with snapshots > RESUME_SNAP removed, so
    --resume restores exactly snapshot_00005 (t=50) with its aux/rungs."""
    dst = f"out/flag_attrib_{name}"
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    shutil.copy2(os.path.join(SRC_DIR, "diagnostics.npz"), dst)
    for i in range(RESUME_SNAP + 1):
        shutil.copy2(os.path.join(SRC_DIR, f"snapshot_{i:05d}.npz"), dst)
    return dst


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
    if os.path.exists("bench/flagship_attrib.json"):
        with open("bench/flagship_attrib.json") as f:
            summary = json.load(f)          # merge across invocations
    for name in args.variants:
        out_dir = _prep_dir(name)
        ov = dict(VARIANTS[name])
        ov.update({
            "output.out_dir": out_dir,
            "output.t_end": str(T_END),
            "output.snap_every": "1000.0",
            "output.stdout": "false",
        })
        cfg = apply_overrides(
            load_config("configs/flagship_32k.toml"),
            [f"{k}={v}" for k, v in ov.items()])
        print(f"--- variant {name} ---", flush=True)
        res = run(cfg, resume=True)
        t = np.asarray(res.diagnostics["time"])
        col = ("dE_cons_over_E_int" if "dE_cons_over_E_int"
               in res.diagnostics else "dE_over_E_int")
        d = np.asarray(res.diagnostics[col])
        # the resumed series starts at t=50 (row 0 is the re-emitted
        # t0 row); interval diffs inside the window
        dd = np.diff(d)
        i = int(np.argmax(np.abs(dd)))
        summary[name] = {
            "column": col,
            "max_interval_jump": float(dd[i]),
            "t_jump": [float(t[i]), float(t[i + 1])],
            "window_total_change": float(d[-1] - d[0]),
            "n_steps": int(res.n_steps),
            "wall_s": float(res.wall_time_s),
        }
        print(name, json.dumps(summary[name]), flush=True)

    with open("bench/flagship_attrib.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
