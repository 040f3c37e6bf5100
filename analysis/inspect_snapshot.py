#!/usr/bin/env python
"""Print a summary of a snapshot file and optionally plot the cluster.

Usage: python analysis/inspect_snapshot.py out/run/snapshot_00003.npz [--plot xy.png]
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot")
    ap.add_argument("--plot", default=None, help="write an x-y scatter PNG")
    args = ap.parse_args(argv)

    with np.load(args.snapshot, allow_pickle=False) as f:
        pos = np.asarray(f["particles/pos"])
        vel = np.asarray(f["particles/vel"])
        mass = np.asarray(f["particles/mass"], np.float64)
        step = f["@step"].item() if "@step" in f.files else "?"
        print(f"schema v{f['@schema_version'].item()}  "
              f"t={f['@time'].item():.6g}  step={step}  "
              f"N={pos.shape[0]}")
        aux = [k.split("/", 1)[1] for k in f.files
               if k.startswith("integrator/")]
        if "integrator@kind" in f.files or aux:
            kind = (f["integrator@kind"].item()
                    if "integrator@kind" in f.files else None)
            print(f"integrator: {kind} aux={aux}")
        u = {k.split("@", 1)[1]: f[k].item() for k in f.files
             if k.startswith("units@")}
        if u:
            print(f"units: {u}")

    com = (pos * mass[:, None]).sum(0) / mass.sum()
    vcom = (vel * mass[:, None]).sum(0) / mass.sum()
    r = np.linalg.norm(pos - com, axis=1)
    print(f"M={mass.sum():.6g}  |com|={np.linalg.norm(com):.6g}  "
          f"|vcom|={np.linalg.norm(vcom):.6g}")
    print(f"r: median={np.median(r):.4g}  90%={np.quantile(r, 0.9):.4g}  "
          f"max={r.max():.4g}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(pos[:, 0], pos[:, 1], s=1, alpha=0.4, lw=0)
        ax.set_aspect("equal")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        fig.savefig(args.plot, dpi=130, bbox_inches="tight")
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    sys.exit(main())
