#!/usr/bin/env python
"""Render the snapshot sequence of a run directory as frames / a GIF.

Capability parity: SURVEY.md §2.14 — analysis scripts over the snapshot
outputs (schema: docs/SNAPSHOT_SCHEMA.md). Shows tidal stripping: each
frame is an x-y scatter in the chosen frame (galactocentric, or
cluster-centric via density-weighted centre), coloured by speed.

Usage:
  python analysis/movie.py out/c2_king_8k [--out movie.gif]
  python analysis/movie.py out/c2_king_8k --frames-dir frames/ --no-gif
  python analysis/movie.py out/c2 --frame cluster --extent 30

Writes PNG frames (one per snapshot) and, by default, an animated GIF
via matplotlib's Pillow writer (no ffmpeg needed in this environment).
"""
import argparse
import glob
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _snapshots(run_dir):
    files = sorted(glob.glob(os.path.join(run_dir, "snapshot_*.npz")))
    if not files:
        raise SystemExit(f"no snapshot_*.npz under {run_dir}")
    return files


def _load(path):
    with np.load(path, allow_pickle=False) as f:
        pos = np.asarray(f["particles/pos"], np.float64)
        vel = np.asarray(f["particles/vel"], np.float64)
        mass = np.asarray(f["particles/mass"], np.float64)
        t = float(f["@time"]) if "@time" in f.files else np.nan
    return pos, vel, mass, t


def _density_center(pos, mass, iters=4):
    """Shrinking-sphere density centre (robust against stripped tails)."""
    c = (pos * mass[:, None]).sum(0) / mass.sum()
    r_cut = np.inf
    for _ in range(iters):
        r = np.linalg.norm(pos - c, axis=1)
        r_cut = min(r_cut, 2.0 * np.median(r))
        sel = r < r_cut
        if sel.sum() < 16:
            break
        w = mass[sel]
        c = (pos[sel] * w[:, None]).sum(0) / w.sum()
    return c


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None,
                    help="GIF path (default <run_dir>/movie.gif)")
    ap.add_argument("--frames-dir", default=None,
                    help="also keep per-snapshot PNGs here")
    ap.add_argument("--no-gif", action="store_true",
                    help="frames only (requires --frames-dir)")
    ap.add_argument("--frame", choices=("galactic", "cluster"),
                    default="galactic",
                    help="coordinate frame: galactocentric x-y, or "
                         "centred on the cluster density centre")
    ap.add_argument("--extent", type=float, default=None,
                    help="half-width of the plotted square (auto: 1.2x "
                         "max 90%% radius across snapshots)")
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--dpi", type=int, default=110)
    args = ap.parse_args(argv)
    if args.no_gif and not args.frames_dir:
        ap.error("--no-gif needs --frames-dir (nothing would be written)")

    files = _snapshots(args.run_dir)
    snaps = [_load(p) for p in files]

    if args.extent is None:
        r90 = 0.0
        for pos, vel, mass, _ in snaps:
            c = (_density_center(pos, mass) if args.frame == "cluster"
                 else np.zeros(3))
            r = np.linalg.norm(pos[:, :2] - c[:2], axis=1)
            r90 = max(r90, float(np.quantile(r, 0.9)))
        extent = 1.2 * r90 if r90 > 0 else 1.0
    else:
        extent = args.extent

    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)

    fig, ax = plt.subplots(figsize=(6, 6))
    images = []
    for i, (pos, vel, mass, t) in enumerate(snaps):
        c = (_density_center(pos, mass) if args.frame == "cluster"
             else np.zeros(3))
        xy = pos[:, :2] - c[:2]
        speed = np.linalg.norm(vel, axis=1)
        ax.clear()
        ax.scatter(xy[:, 0], xy[:, 1], s=1.0, lw=0, alpha=0.5, c=speed,
                   cmap="viridis")
        ax.set_xlim(-extent, extent)
        ax.set_ylim(-extent, extent)
        ax.set_aspect("equal")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(f"t = {t:.4g}   N = {len(mass)}")
        fig.canvas.draw()
        if args.frames_dir:
            fp = os.path.join(args.frames_dir, f"frame_{i:05d}.png")
            fig.savefig(fp, dpi=args.dpi, bbox_inches="tight")
        if not args.no_gif:
            buf = np.asarray(fig.canvas.buffer_rgba())
            images.append(buf.copy())

    written = []
    if args.frames_dir:
        written.append(f"{len(snaps)} frames -> {args.frames_dir}")
    if not args.no_gif:
        from PIL import Image

        out = args.out or os.path.join(args.run_dir, "movie.gif")
        ims = [Image.fromarray(im[..., :3]) for im in images]
        ims[0].save(out, save_all=True, append_images=ims[1:],
                    duration=int(1000 / max(args.fps, 1)), loop=0)
        written.append(out)
    print("wrote " + "; ".join(written))


if __name__ == "__main__":
    sys.exit(main())
