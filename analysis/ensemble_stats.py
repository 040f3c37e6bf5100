#!/usr/bin/env python
"""Survey summaries over an ensemble.npz (oc_nbody_tpu.ensemble output).

Per member: seed (and sweep value), final bound-mass fraction, final
half-mass radius, peak |dE/E_int|, and the dissolution time (first
diagnostics time with N_bound == 0; '-' if still alive). Then ensemble
mean/scatter — the numbers a survey actually wants, straight off the
(T, E) columns.

Usage: python analysis/ensemble_stats.py out/run/ensemble.npz [--json]
"""
import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from oc_nbody_tpu.ensemble import read_ensemble  # noqa: E402


def summarize(path, drift_warn=0.0):
    """Per-member summary rows; with ``drift_warn > 0`` each row gains a
    ``drift_flag`` marking members whose peak |dE/E_int| exceeds the
    bound — one mis-stepped member in a survey is integrator error
    reported as physics unless flagged (VERDICT round-3 W3)."""
    _, seeds, table, fin = read_ensemble(path)
    t = table["time"][:, 0]
    e = len(seeds)
    mb = table["M_bound"] / np.maximum(table["M_bound"][0], 1e-300)
    nb = table["N_bound"]
    # ledger-corrected residual when present (SEV surveys): raw dE/E
    # under mass loss is physics, not integrator error
    drift = (np.abs(table["dE_cons_over_E_int"])
             if "dE_cons_over_E_int" in table
             else np.abs(table["dE_over_E_int"])
             if "dE_over_E_int" in table
             else np.abs((table["E_tot"] - table["E_tot"][0])
                         / np.abs(table["E_int"][0])))
    rows = []
    for i in range(e):
        dead = np.nonzero(nb[:, i] == 0)[0]
        row = {
            "seed": int(seeds[i]),
            # TWO bound-mass normalizations (round-4 VERDICT W4 — both are
            # defensible, so both are emitted and named):
            #   M_bound_final      = M_bound(T) / M_bound(0): fraction of
            #                        the member's INITIALLY-BOUND mass
            #                        (the survey-retention statistic);
            #   M_bound_final_raw  = M_bound(T) as stored in the H5
            #                        diagnostics column — absolute code
            #                        units, i.e. fraction of the initial
            #                        TOTAL mass in Hénon units (M_tot(0)=1).
            # Re-deriving from the H5 directly gives the _raw numbers.
            "M_bound_final": float(mb[-1, i]),
            "M_bound_final_raw": float(table["M_bound"][-1, i]),
            "r_half_final": float(table["r_lagr_50"][-1, i]),
            "max_drift": float(drift[:, i].max()),
            "t_dissolve": float(t[dead[0]]) if dead.size else None,
        }
        if drift_warn > 0:
            row["drift_flag"] = bool(row["max_drift"] > drift_warn)
        if "sweep_values" in fin:
            row[fin["sweep_key"]] = float(fin["sweep_values"][i])
        rows.append(row)
    return rows


def plot(path, out):
    """Survey figure: bound-mass evolution per sweep group (mean line +
    min/max band across seeds) and the final-value summary."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, seeds, table, fin = read_ensemble(path)
    t = table["time"][:, 0]
    mb = table["M_bound"] / np.maximum(table["M_bound"][0], 1e-300)
    if "sweep_values" in fin:
        key = fin["sweep_key"]
        vals = np.asarray(fin["sweep_values"], float)
        groups = [(f"{key}={v:g}", mb[:, vals == v]) for v in
                  sorted(set(vals.tolist()))]
    else:
        groups = [(f"{mb.shape[1]} seeds", mb)]

    fig, axes = plt.subplots(1, 2, figsize=(11, 3.8), constrained_layout=True)
    for label, g in groups:
        (line,) = axes[0].plot(t, g.mean(axis=1), label=label)
        axes[0].fill_between(t, g.min(axis=1), g.max(axis=1),
                             color=line.get_color(), alpha=0.2, lw=0)
    axes[0].set_xlabel("t [code units]")
    axes[0].set_ylabel("M_bound / M_bound(0)")
    axes[0].set_title(f"bound mass, {mb.shape[1]} members")
    axes[0].legend(fontsize=8)

    finals = [g[-1] for _, g in groups]
    axes[1].errorbar(range(len(groups)), [f.mean() for f in finals],
                     yerr=[f.std() for f in finals], fmt="o", capsize=4)
    for i, f in enumerate(finals):  # per-seed scatter behind the mean
        axes[1].plot(np.full(f.size, i), f, ".", color="0.6", ms=4, zorder=0)
    axes[1].set_xticks(range(len(groups)),
                       [lbl for lbl, _ in groups], fontsize=8)
    axes[1].set_ylabel("final M_bound fraction")
    axes[1].set_title("final, mean ± σ over seeds")
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--save", default=None, metavar="FIG.png",
                    help="write the survey figure (bound-mass evolution "
                         "per sweep group + final-value summary)")
    ap.add_argument("--drift-warn", type=float, default=0.0,
                    help="flag members whose peak |dE/E_int| exceeds this "
                         "bound (0 = off)")
    args = ap.parse_args(argv)
    if args.save:
        plot(args.path, args.save)
    rows = summarize(args.path, drift_warn=args.drift_warn)
    n_flag = sum(1 for r in rows if r.get("drift_flag"))
    if n_flag:
        bad = [r["seed"] for r in rows if r.get("drift_flag")]
        print(f"WARNING: {n_flag} member(s) exceed |dE/E_int| = "
              f"{args.drift_warn:g}: seeds {bad} — treat their physics "
              "columns as suspect", file=sys.stderr)
    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    keys = list(rows[0].keys())
    print("  ".join(f"{k:>14s}" for k in keys))
    for r in rows:
        print("  ".join(
            f"{('-' if r[k] is None else (f'{r[k]:.4g}' if isinstance(r[k], float) else str(r[k]))):>14s}"
            for k in keys))
    mbf = np.array([r["M_bound_final"] for r in rows])
    mbr = np.array([r["M_bound_final_raw"] for r in rows])
    print(f"\nensemble: {len(rows)} members; M_bound_final = "
          f"{mbf.mean():.3f} +- {mbf.std():.3f} (of initially-bound mass; "
          f"raw H5 column = {mbr.mean():.3f} +- {mbr.std():.3f} "
          "of initial total mass)")
    td = [r["t_dissolve"] for r in rows if r["t_dissolve"] is not None]
    if td:
        print(f"dissolved: {len(td)}/{len(rows)}; t_dissolve = "
              f"{np.mean(td):.4g} +- {np.std(td):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
