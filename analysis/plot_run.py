#!/usr/bin/env python
"""Plot the diagnostics time series of a run directory.

Capability parity: SURVEY.md §2.14 — analysis scripts that read the snapshot
/ diagnostics outputs (schema: docs/SNAPSHOT_SCHEMA.md).

Usage: python analysis/plot_run.py out/c1_plummer_1k [--out plots.png]
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
        d = {k: np.asarray(f[k]) for k in f.files}
    # legacy tables written before the writer kept columns row-aligned can
    # have short columns; NaN-pad so every panel can plot against `time`
    n = max((len(v) for v in d.values()), default=0)
    return {k: (np.concatenate([v, np.full(n - len(v), np.nan)])
                if len(v) < n else v) for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None, help="output PNG path")
    ap.add_argument("--orbit", action="store_true",
                    help="also write <out_stem>_orbit.png: the cluster "
                    "density-centre's galactocentric track (R(t), z(t), "
                    "x-y) from the cx/cy/cz diagnostics columns")
    ap.add_argument("--structure", action="store_true",
                    help="also write <out_stem>_structure.png: core "
                    "radius vs half-mass radius, central density, "
                    "velocity dispersion / virial ratio, and time in "
                    "units of the (evolving) relaxation time")
    args = ap.parse_args(argv)

    d = load_diagnostics(args.run_dir)
    t = d["time"]
    fig, axes = plt.subplots(2, 2, figsize=(11, 8), constrained_layout=True)

    ax = axes[0, 0]
    ax.plot(t, d["dE_over_E"], lw=1, label="dE / |E_tot(0)|")
    if "dE_over_E_int" in d:
        # normalised by the CLUSTER's internal energy — the honest drift
        # metric on orbit runs where E_tot is galaxy-dominated
        ax.plot(t, d["dE_over_E_int"], lw=1, ls="--",
                label="dE / |E_int(0)|")
    if "dEJ_over_EJ" in d:
        # rotating pattern configured: the Jacobi integral is the
        # conserved quantity (constant only after any growth ramp)
        ax.plot(t, d["dEJ_over_EJ"], lw=1, ls=":", label="dE_J / |E_J(0)|")
    if "dE_cons_over_E_int" in d:
        # stellar evolution / escape pruning configured: E_tot steps at
        # every out-of-band event, so the conservation check is the
        # ledger-corrected residual (E_sev_cum + E_prune_cum subtracted)
        ax.plot(t, d["dE_cons_over_E_int"], lw=1, ls="-.",
                label="(dE − ledgers) / |E_int(0)|")
    if ("dE_over_E_int" in d or "dEJ_over_EJ" in d
            or "dE_cons_over_E_int" in d):
        ax.legend(fontsize=8)
    ax.set_xlabel("t [code]")
    ax.set_ylabel("dE/E")
    ax.set_title("energy drift")

    ax = axes[0, 1]
    for frac in (10, 25, 50, 75, 90):
        key = f"r_lagr_{frac}"
        if key in d:
            ax.plot(t, d[key], lw=1, label=f"{frac}%")
    ax.set_yscale("log")
    ax.set_xlabel("t [code]")
    ax.set_ylabel("r [code]")
    ax.set_title("Lagrangian radii")
    ax.legend(fontsize=8)

    ax = axes[1, 0]
    if "M_bound" in d:
        ax.plot(t, d["M_bound"] / d["M_bound"][0], lw=1, label="M_bound")
    if "M_tot" in d:
        # stellar-evolution runs: total mass steps down at each death —
        # distinct from tidal stripping (bound-fraction) losses
        ax.plot(t, d["M_tot"] / d["M_tot"][0], lw=1, ls="--",
                color="tab:purple", label="M_tot (stellar evolution)")
        ax.legend(fontsize=8)
    if "N_cluster" in d:
        # escape pruning: the source-partition fraction (stars still
        # treated as pairwise sources) tracks — and lags — the bound mass
        n0 = np.nanmax(d["N_cluster"])
        ax.plot(t, d["N_cluster"] / max(n0, 1), lw=1, ls=":",
                color="tab:brown", label="N_cluster/N (prune partition)")
        ax.legend(fontsize=8)
    ax.set_xlabel("t [code]")
    ax.set_ylabel("M / M(0)")
    ax.set_title("bound mass (tidal stripping)")
    if "d_pert" in d:
        # flyby runs: overlay the perturber-cluster separation so closest
        # approach lines up with any step in the stripping curve
        ax2 = ax.twinx()
        ax2.plot(t, d["d_pert"], lw=1, color="tab:red", alpha=0.6)
        ax2.set_yscale("log")
        ax2.set_ylabel("d_pert [code]", color="tab:red")

    ax = axes[1, 1]
    ax.plot(t, d["KE"], label="KE", lw=1)
    ax.plot(t, d["PE_pair"], label="PE_pair", lw=1)
    if "E_ext" in d:
        ax.plot(t, d["E_ext"], label="E_ext", lw=1)
    ax.plot(t, d["E_tot"], label="E_tot", lw=1.5, color="k")
    ax.set_xlabel("t [code]")
    ax.set_ylabel("E [code]")
    ax.set_title("energy budget")
    ax.legend(fontsize=8)

    out = args.out or os.path.join(args.run_dir, "diagnostics.png")
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")

    if args.structure and "sigma_1d" in d:
        fig3, axes3 = plt.subplots(1, 4, figsize=(16, 3.6),
                                   constrained_layout=True)
        ax = axes3[0]
        if "r_core" in d:
            ax.plot(t, d["r_core"], lw=1, label="r_core (CH85)")
        if "r_lagr_50" in d:
            ax.plot(t, d["r_lagr_50"], lw=1, ls="--", label="r_half")
        ax.set_yscale("log")
        ax.set_xlabel("t [code]")
        ax.set_ylabel("r [code]")
        ax.set_title("core vs half-mass radius")
        ax.legend(fontsize=8)

        ax = axes3[1]
        if "rho_core" in d:
            ax.plot(t, d["rho_core"], lw=1)
            ax.set_yscale("log")
        ax.set_xlabel("t [code]")
        ax.set_ylabel(r"$\rho_{core}$ [code]")
        ax.set_title("central density (core collapse up, "
                     "expansion down)")

        ax = axes3[2]
        ax.plot(t, d["sigma_1d"], lw=1, label=r"$\sigma_{1D}$")
        ax.set_xlabel("t [code]")
        ax.set_ylabel(r"$\sigma_{1D}$ [code]")
        ax.set_title("velocity dispersion / virial ratio")
        if "Q_virial" in d:
            ax2 = ax.twinx()
            ax2.plot(t, d["Q_virial"], lw=1, color="tab:orange", alpha=0.7)
            ax2.axhline(0.5, ls=":", c="gray")
            ax2.set_ylabel("Q = KE/|W|", color="tab:orange")

        ax = axes3[3]
        if "t_rh" in d:
            # elapsed time in units of the CURRENT relaxation time — the
            # dynamical-age clock (core collapse at ~15-20 t_rh for
            # equal masses, much earlier with a mass spectrum). Intervals
            # with NaN t_rh (NaN-backfilled pre-feature rows on resumed
            # runs, or N_bound < 2) contribute zero age instead of
            # poisoning the cumulative sum.
            with np.errstate(invalid="ignore", divide="ignore"):
                inc = np.diff(t) / d["t_rh"][1:]
            inc = np.where(np.isfinite(inc), inc, 0.0)
            age = np.concatenate([[0.0], np.cumsum(inc)])
            ax.plot(t, age, lw=1)
        ax.set_xlabel("t [code]")
        ax.set_ylabel(r"$\int dt / t_{rh}(t)$")
        ax.set_title("relaxation age")
        out3 = os.path.splitext(out)[0] + "_structure.png"
        fig3.savefig(out3, dpi=130)
        print(f"wrote {out3}")

    if args.orbit and all(k in d for k in ("cx", "cy", "cz")):
        R = np.hypot(d["cx"], d["cy"])
        fig2, axes2 = plt.subplots(1, 3, figsize=(13, 3.6),
                                   constrained_layout=True)
        axes2[0].plot(t, R, lw=1)
        axes2[0].set_xlabel("t [code]")
        axes2[0].set_ylabel("R [code]")
        axes2[0].set_title("galactocentric radius")
        axes2[1].plot(t, d["cz"], lw=1)
        axes2[1].axhline(0.0, ls=":", c="gray")
        axes2[1].set_xlabel("t [code]")
        axes2[1].set_ylabel("z [code]")
        axes2[1].set_title("height (disk crossings)")
        axes2[2].plot(d["cx"], d["cy"], lw=1)
        axes2[2].plot(d["cx"][0], d["cy"][0], "o", ms=5, c="tab:green")
        axes2[2].set_aspect("equal")
        axes2[2].set_xlabel("x [code]")
        axes2[2].set_ylabel("y [code]")
        axes2[2].set_title("in-plane track")
        out2 = os.path.splitext(out)[0] + "_orbit.png"
        fig2.savefig(out2, dpi=130)
        print(f"wrote {out2}")


if __name__ == "__main__":
    sys.exit(main())
