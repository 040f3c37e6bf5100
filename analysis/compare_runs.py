#!/usr/bin/env python
"""Overlay the diagnostics of several runs for convergence/parameter studies.

Capability parity: SURVEY.md §2.14 (analysis scripts). Round-2 addition:
the dt/eta convergence studies behind the acceptance results were done by
exactly this comparison — this tool makes them one command.

Usage:
    python analysis/compare_runs.py out/run_a out/run_b [--labels a b]
        [--columns dE_over_E_int M_bound] [--out compare.png]
"""
import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def load_diagnostics(run_dir):
    path = os.path.join(run_dir, "diagnostics.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: np.asarray(f[k]) for k in f.files}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("--labels", nargs="*", default=None)
    ap.add_argument("--columns", nargs="*",
                    default=["dE_over_E_int", "M_bound", "r_lagr_50"])
    ap.add_argument("--out", default="compare.png")
    args = ap.parse_args(argv)

    labels = args.labels or [os.path.basename(os.path.normpath(d))
                             for d in args.run_dirs]
    runs = [(lab, load_diagnostics(d))
            for lab, d in zip(labels, args.run_dirs)]

    cols = [c for c in args.columns if any(c in d for _, d in runs)]
    if not cols:
        raise SystemExit(f"none of {args.columns} present in the runs")
    fig, axes = plt.subplots(len(cols), 1, figsize=(9, 3.2 * len(cols)),
                             constrained_layout=True, squeeze=False)
    for ax, col in zip(axes[:, 0], cols):
        for lab, d in runs:
            if col in d:
                ax.plot(d["time"], d[col], lw=1, label=lab)
        ax.set_xlabel("t [code]")
        ax.set_ylabel(col)
        ax.legend(fontsize=8)
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
