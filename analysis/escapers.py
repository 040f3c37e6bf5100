#!/usr/bin/env python
"""Escaper census and tidal-tail morphology from a run's snapshot sequence.

Capability parity: SURVEY.md §2.14 "analysis scripts ... mass loss" — the
per-particle view of tidal stripping that the driver's M_bound time series
(plot_run.py) aggregates away: WHO escapes, WHEN, and into which tail.

For every snapshot the bound set is recomputed with the same iterative
tidal-radius cut the on-device diagnostics use (diagnostics.bound_mass_tidal,
tensor method — correct on inclined/disk-crossing orbits), with the external
potential rebuilt from the snapshot's embedded config_json. A particle's
escape time is the time of the first snapshot after which it NEVER rejoins
the bound set (transient excursions past r_t do not count). Escapers in the
final snapshot are split into the leading (inner, ahead of the cluster) and
trailing (outer) tails by galactocentric radius relative to the cluster
centre.

Usage:
    python analysis/escapers.py out/c2_king_8k             # a run directory
    python analysis/escapers.py out/c2 --save tails.png --csv escapers.csv
"""
import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def _build_force(cfg_json):
    """External potential + force model from the snapshot's stored config
    (no IC regeneration — only the analytic field and units are needed)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.config import SimConfig
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.scene import build_external_potential, build_units

    cfg = SimConfig.from_dict(json.loads(cfg_json))
    us = build_units(cfg)
    external = build_external_potential(cfg, us)
    force = make_force_model(eps=cfg.integrator.eps, G=us.G,
                             external=external, backend="jnp")
    return force, us


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", help="run output directory with snapshot_*.npz")
    ap.add_argument("--save", default=None, help="write the figure here "
                    "(default <run_dir>/escapers.png)")
    ap.add_argument("--csv", default=None,
                    help="optionally write per-escaper rows (id, t_escape, "
                    "tail) as CSV")
    args = ap.parse_args(argv)

    snaps = sorted(glob.glob(os.path.join(args.run_dir, "snapshot_*.npz")))
    if len(snaps) < 2:
        print(f"need >= 2 snapshots in {args.run_dir}, found {len(snaps)}")
        return 1

    pos0, vel0, mass0, ids0, t0, cfg_json = _load(snaps[0])
    if cfg_json is None:
        print("snapshots carry no config_json; cannot rebuild the potential")
        return 1
    force, us = _build_force(cfg_json)

    import jax.numpy as jnp

    from oc_nbody_tpu.diagnostics import bound_mass_tidal, density_center
    from oc_nbody_tpu.state import ParticleState

    order0 = np.argsort(ids0)
    n = ids0.size
    bound_hist = np.zeros((len(snaps), n), dtype=bool)  # id-sorted rows
    times = np.zeros(len(snaps))
    centers = np.zeros((len(snaps), 3))
    last = None
    for k, path in enumerate(snaps):
        pos, vel, mass, ids, t, _ = _load(path)
        st = ParticleState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                           mass=jnp.asarray(mass),
                           ids=jnp.asarray(ids),
                           time=jnp.asarray(t, jnp.float64))
        m_b, n_b, r_t, mask = bound_mass_tidal(st, force)
        order = np.argsort(ids)
        bound_hist[k, :] = np.asarray(mask, bool)[order]
        times[k] = t
        centers[k] = np.asarray(density_center(st))
        last = (pos[order], vel[order], mass[order], ids[order], t)
        print(f"t={t:10.4f}  M_bound={float(m_b):.4f}  N_bound={int(n_b):6d}"
              f"  r_t={float(r_t):.3f}")

    # escape time: first snapshot index after which the particle never
    # rejoins the bound set (suffix-OR rules out transient r_t excursions)
    ever_bound_after = np.logical_or.accumulate(bound_hist[::-1], 0)[::-1]
    escaped = ~ever_bound_after[-1]                     # unbound at the end
    first_free = np.full(n, -1)
    for k in range(len(snaps)):
        newly = escaped & (first_free < 0) & ~ever_bound_after[k]
        first_free[newly] = k
    t_escape = np.where(first_free >= 0, times[np.maximum(first_free, 0)],
                        np.nan)

    pos_f, vel_f, mass_f, ids_f, t_f = last
    c_f = centers[-1]
    r_gal = np.linalg.norm(pos_f[:, :2], axis=1)
    r_c = np.linalg.norm(c_f[:2])
    leading = escaped & (r_gal < r_c)                   # inner tail leads
    trailing = escaped & ~leading

    m_tot = mass_f.sum()
    m_esc = mass_f[escaped].sum()
    print(f"\nescapers: {int(escaped.sum())}/{n} particles, "
          f"{m_esc / m_tot:.1%} of the mass "
          f"(leading {int(leading.sum())}, trailing {int(trailing.sum())})")

    if args.csv:
        rows = np.argwhere(escaped)[:, 0]
        with open(args.csv, "w") as fh:
            fh.write("id,t_escape,tail\n")
            for i in rows:
                tail = "leading" if leading[i] else "trailing"
                fh.write(f"{int(ids_f[i])},{t_escape[i]:.6g},{tail}\n")
        print(f"wrote {args.csv}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.6))
    ax = axes[0]
    esc_mass_vs_t = [(mass_f[escaped & (first_free <= k) & (first_free >= 0)]
                      .sum() / m_tot) for k in range(len(snaps))]
    ax.plot(times, esc_mass_vs_t, lw=2)
    ax.set_xlabel("t [code]"), ax.set_ylabel("escaped mass fraction")
    ax.set_title("cumulative stripping")
    ax = axes[1]
    if np.isfinite(t_escape).any():
        ax.hist(t_escape[np.isfinite(t_escape)], bins=min(40, len(snaps) * 2))
    ax.set_xlabel("escape time [code]"), ax.set_ylabel("N escapers")
    ax.set_title("escape-time distribution")
    ax = axes[2]
    ax.scatter(pos_f[~escaped, 0], pos_f[~escaped, 1], s=1, c="0.7",
               label="bound")
    ax.scatter(pos_f[leading, 0], pos_f[leading, 1], s=2, c="tab:blue",
               label="leading tail")
    ax.scatter(pos_f[trailing, 0], pos_f[trailing, 1], s=2, c="tab:red",
               label="trailing tail")
    ax.plot(*c_f[:2], "k+", ms=12)
    ax.set_aspect("equal"), ax.legend(markerscale=4, fontsize=8)
    ax.set_xlabel("x [code]"), ax.set_ylabel("y [code]")
    ax.set_title(f"t = {t_f:.3f} (galactocentric)")
    fig.tight_layout()
    out = args.save or os.path.join(args.run_dir, "escapers.png")
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
