#!/usr/bin/env python
"""Bound-pair (binary) census over a snapshot.

Capability extension over SURVEY.md §2.14 (the reference tree is empty —
SURVEY.md §0): with primordial binaries in the ICs (models/binaries.py,
ic.binary_fraction) the natural companion analysis is finding which pairs
are still bound at later times — binary survival/disruption is one of the
standard open-cluster observables.

Method: mutual-nearest-neighbour candidates (i's nearest neighbour is j
AND j's is i), then two-body orbital elements from the relative phase-space
coordinates (models/binaries.orbital_elements); a pair is a binary when its
two-body energy is negative (a > 0). Pairs are flagged "hard" when their
binding energy G m1 m2 / (2a) exceeds the mean stellar kinetic energy of
the snapshot (Heggie's criterion: hard binaries harden, soft ones are
ionised). The NN search is an exact chunked O(N^2) sweep in numpy — no
tree approximations, matching the framework's direct-summation character.

Usage:
    python analysis/binaries.py out/run/snapshot_000012.npz
    python analysis/binaries.py out/run            # latest snapshot in dir
    python analysis/binaries.py out/run --csv pairs.csv --save ae.png
"""
import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pick_snapshot(path):
    if os.path.isdir(path):
        snaps = sorted(glob.glob(os.path.join(path, "snapshot_*.npz")))
        if not snaps:
            raise SystemExit(f"no snapshot_*.npz in {path}")
        return snaps[-1]
    return path


def _load(path):
    with np.load(path, allow_pickle=False) as f:
        pos = np.asarray(f["particles/pos"], np.float64)
        vel = np.asarray(f["particles/vel"], np.float64)
        mass = np.asarray(f["particles/mass"], np.float64)
        ids = (np.asarray(f["particles/ids"]) if "particles/ids" in f.files
               else np.arange(pos.shape[0]))
        t = float(f["@time"]) if "@time" in f.files else np.nan
        cfg_json = (f["@config_json"].item() if "@config_json" in f.files
                    else None)
    return pos, vel, mass, ids, t, cfg_json


def nearest_neighbours(pos, chunk=512):
    """Exact nearest neighbour of every particle, chunked O(N^2).

    Positions are centred on their mean before the f32 cast: snapshots are
    galactocentric (|r| ~ thousands of code units) and the
    |ri|^2+|rj|^2-2ri.rj form would otherwise lose every binary-scale
    separation to f32 cancellation (measured: an uncentred sweep found 49
    of 2458 injected pairs at R = 8 kpc; centred finds them all)."""
    n = pos.shape[0]
    nn = np.empty(n, np.int64)
    p32 = (pos - pos.mean(axis=0)).astype(np.float32)
    sq = np.einsum("ij,ij->i", p32, p32)
    for i0 in range(0, n, chunk):
        rows = p32[i0:i0 + chunk]
        d2 = sq[i0:i0 + chunk, None] + sq[None, :] - 2.0 * (rows @ p32.T)
        idx = np.arange(i0, min(i0 + chunk, n))
        d2[np.arange(len(idx)), idx] = np.inf  # exclude self
        nn[i0:i0 + chunk] = np.argmin(d2, axis=1)
    return nn


def census(pos, vel, mass, G=1.0, chunk=512):
    """Return a dict of arrays for every bound mutual-NN pair.

    Keys: i, j (indices, i < j), a, e, e_bind (G m1 m2 / 2a), hard (bool).
    """
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.models.binaries import orbital_elements

    nn = nearest_neighbours(pos, chunk=chunk)
    i = np.arange(pos.shape[0])
    mutual = (nn[nn[i]] == i) & (i < nn[i])
    ii, jj = i[mutual], nn[i][mutual]

    gm = G * (mass[ii] + mass[jj])
    a, e = orbital_elements(pos[ii] - pos[jj], vel[ii] - vel[jj], gm)
    a = np.asarray(a)
    e = np.asarray(e)
    bound = a > 0
    ii, jj, a, e = ii[bound], jj[bound], a[bound], e[bound]

    e_bind = G * mass[ii] * mass[jj] / (2.0 * a)
    # Heggie hard/soft boundary: binding energy vs mean stellar KE of the
    # cluster frame (bulk motion removed)
    mtot = mass.sum()
    vcom = (vel * mass[:, None]).sum(0) / mtot
    ke_mean = float(0.5 * (mass * ((vel - vcom) ** 2).sum(1)).mean())
    return dict(i=ii, j=jj, a=a, e=e, e_bind=e_bind,
                hard=e_bind > ke_mean, ke_mean=ke_mean)


def _evolution(run_dir, G, chunk):
    """Pair counts and survival across a run's snapshot sequence.

    Survival tracks the FIRST snapshot's pairs by particle id: a pair
    "survives" at time t if the same (id, id) couple is still a bound
    mutual-NN pair then (exchanges count as loss — rare and deliberate)."""
    snaps = sorted(glob.glob(os.path.join(run_dir, "snapshot_*.npz")))
    if not snaps:
        raise SystemExit(f"no snapshot_*.npz in {run_dir}")
    initial = None
    print(f"{'t':>12} {'pairs':>7} {'hard':>6} {'survive':>8}")
    for snap in snaps:
        pos, vel, mass, ids, t, _ = _load(snap)
        c = census(pos, vel, mass, G=G, chunk=chunk)
        pairs = {tuple(sorted((int(ids[a]), int(ids[b]))))
                 for a, b in zip(c["i"], c["j"])}
        if initial is None:
            initial = pairs
        frac = len(pairs & initial) / max(len(initial), 1)
        print(f"{t:>12.5g} {len(pairs):>7d} {int(c['hard'].sum()):>6d} "
              f"{frac:>8.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot", help="snapshot file or run directory")
    ap.add_argument("--csv", default=None, help="write per-pair CSV")
    ap.add_argument("--save", default=None, help="save an (a, e) figure")
    ap.add_argument("--chunk", type=int, default=512,
                    help="NN-sweep row chunk (memory/time tradeoff)")
    ap.add_argument("--evolution", action="store_true",
                    help="census every snapshot in the run directory: pair "
                         "counts + survival of the first snapshot's pairs")
    args = ap.parse_args(argv)

    if args.evolution:
        run_dir = (args.snapshot if os.path.isdir(args.snapshot)
                   else os.path.dirname(args.snapshot))
        first = _pick_snapshot(run_dir)
        _, _, _, _, _, cfg_json = _load(first)
        G = 1.0
        if cfg_json is not None:
            from oc_nbody_tpu.config import SimConfig
            from oc_nbody_tpu.scene import build_units
            G = float(build_units(SimConfig.from_dict(
                json.loads(cfg_json))).G)
        _evolution(run_dir, G, args.chunk)
        return 0

    snap = _pick_snapshot(args.snapshot)
    pos, vel, mass, ids, t, cfg_json = _load(snap)

    G = 1.0
    if cfg_json is not None:
        from oc_nbody_tpu.config import SimConfig
        from oc_nbody_tpu.scene import build_units
        cfg = SimConfig.from_dict(json.loads(cfg_json))
        G = float(build_units(cfg).G)

    c = census(pos, vel, mass, G=G, chunk=args.chunk)
    n_pairs = len(c["a"])
    n_sys = pos.shape[0] - n_pairs  # pairs count once as systems
    print(f"{os.path.basename(snap)}  t={t:.6g}  N={pos.shape[0]}")
    print(f"binaries: {n_pairs} bound mutual-NN pairs "
          f"({100.0 * n_pairs / max(n_sys, 1):.2f}% of systems), "
          f"{int(c['hard'].sum())} hard / {int((~c['hard']).sum())} soft "
          f"(<KE> = {c['ke_mean']:.4g})")
    if n_pairs:
        qs = np.percentile(c["a"], [10, 50, 90])
        print(f"a percentiles 10/50/90: {qs[0]:.4g} / {qs[1]:.4g} / "
              f"{qs[2]:.4g} (code units); median e = "
              f"{np.median(c['e']):.3f}")

    if args.csv:
        hdr = "id_i,id_j,a,e,e_bind,hard"
        rows = np.column_stack([ids[c["i"]], ids[c["j"]], c["a"], c["e"],
                                c["e_bind"], c["hard"].astype(int)])
        np.savetxt(args.csv, rows, delimiter=",", header=hdr, comments="",
                   fmt=["%d", "%d", "%.8g", "%.6f", "%.8g", "%d"])
        print(f"wrote {args.csv}")

    if args.save:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4.5))
        if n_pairs:
            hard = c["hard"]
            ax.scatter(c["a"][hard], c["e"][hard], s=12, label="hard")
            ax.scatter(c["a"][~hard], c["e"][~hard], s=12, marker="x",
                       label="soft")
            ax.set_xscale("log")
            ax.legend()
        ax.set_xlabel("semi-major axis a (code units)")
        ax.set_ylabel("eccentricity e")
        ax.set_title(f"bound pairs, t={t:.4g}")
        fig.tight_layout()
        fig.savefig(args.save, dpi=130)
        print(f"wrote {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
