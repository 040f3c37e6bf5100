#!/usr/bin/env python
"""Import/export adapter between oc_nbody_tpu snapshots and generic
N-body interchange formats.

SURVEY.md §7 lists a reference-schema adapter as a hard part; the
reference tree is empty (SURVEY.md §0), so the realizable form is this
universal adapter for the formats the wider toolchain actually speaks:

* plain tables (``.txt`` / ``.dat`` / ``.csv``): one row per star,
  ``m x y z vx vy vz`` — the de-facto interchange layout written by
  McLuster, NBODY6's fort.10, and most snapshot dumpers. An optional
  leading integer column is treated as particle ids (8 columns total).
  Whitespace- or comma-delimited, ``#`` comments ignored.
* NumPy archives (``.npz``): arrays ``mass`` (N,), ``pos`` (N,3),
  ``vel`` (N,3); optional ``ids`` (N,) and scalar ``time``.
  (``.npy``: a single (N,7) or (N,8) array, table column order.)

Usage:
  # foreign IC -> snapshot usable as  [ic] kind="file"  file="ic.npz"
  python analysis/convert.py import cluster.dat ic.npz \
      [--mass-scale S] [--length-scale S] [--velocity-scale S] [--time T]

  # snapshot -> table/archive for foreign tools
  python analysis/convert.py export out/run/snapshot_00004.npz snap.csv
  python analysis/convert.py export out/run/snapshot_00004.npz snap.npz

The ``--*-scale`` factors multiply the input columns on import (use them
to convert physical units into code units: e.g. masses in Msun with
Hénon ``units.mass_msun = M`` need ``--mass-scale 1/M`` applied via its
decimal value). Export writes code units as stored, with the snapshot's
unit attrs echoed in the CSV header when present.
"""
import argparse
import os

import numpy as np

# Like every analysis script, this one speaks the documented snapshot
# schema (docs/SNAPSHOT_SCHEMA.md) with numpy ONLY — importing the engine
# would pull in jax (an IC converter must work on a login node with no
# accelerator).
SCHEMA_VERSION = 1  # io/snapshot.py:40


def _load_table(path):
    """Plain-table reader: 7 cols (m x y z vx vy vz) or 8 (id first)."""
    try:
        data = np.loadtxt(path, comments="#", ndmin=2)
    except ValueError:
        data = np.loadtxt(path, comments="#", delimiter=",", ndmin=2)
    if data.shape[1] == 8:
        ids, data = data[:, 0].astype(np.int32), data[:, 1:]
    elif data.shape[1] == 7:
        ids = None
    else:
        raise SystemExit(
            f"{path}: expected 7 columns (m x y z vx vy vz) or 8 (leading "
            f"id), got {data.shape[1]}")
    return data[:, 0], data[:, 1:4], data[:, 4:7], ids, 0.0


def _load_npz(path):
    with np.load(path) as z:
        if not {"mass", "pos", "vel"} <= set(z.files):
            raise SystemExit(
                f"{path}: need arrays mass/pos/vel (have {sorted(z.files)})")
        ids = z["ids"].astype(np.int32) if "ids" in z.files else None
        time = float(z["time"]) if "time" in z.files else 0.0
        return (np.asarray(z["mass"], np.float64), np.asarray(z["pos"]),
                np.asarray(z["vel"]), ids, time)


def _load_npy(path):
    data = np.load(path)
    if data.ndim != 2 or data.shape[1] not in (7, 8):
        raise SystemExit(f"{path}: expected an (N,7) or (N,8) array, got "
                         f"{data.shape}")
    if data.shape[1] == 8:
        return data[:, 1], data[:, 2:5], data[:, 5:8], \
            data[:, 0].astype(np.int32), 0.0
    return data[:, 0], data[:, 1:4], data[:, 4:7], None, 0.0


def do_import(args):
    ext = os.path.splitext(args.input)[1].lower()
    loader = {".npz": _load_npz, ".npy": _load_npy}.get(ext, _load_table)
    mass, pos, vel, ids, time = loader(args.input)
    mass = np.asarray(mass, np.float64) * args.mass_scale
    pos = np.asarray(pos, np.float64) * args.length_scale
    vel = np.asarray(vel, np.float64) * args.velocity_scale
    if args.time is not None:
        time = args.time
    n = pos.shape[0]
    if pos.shape != (n, 3) or vel.shape != (n, 3) or mass.shape != (n,):
        raise SystemExit(f"bad shapes: pos {pos.shape}, vel {vel.shape}, "
                         f"mass {mass.shape}")
    if ids is None:
        ids = np.arange(n, dtype=np.int32)

    # schema v1, written directly (matches io/snapshot.py:_write_file;
    # atomic via .tmp + rename like the engine's writer)
    tmp = args.output + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **{
            "particles/pos": np.asarray(pos, np.float64),
            "particles/vel": np.asarray(vel, np.float64),
            "particles/mass": np.asarray(mass, np.float32),
            "particles/ids": np.asarray(ids, np.int32),
            "particles@n": np.asarray(n),
            "@schema_version": np.asarray(SCHEMA_VERSION),
            "@time": np.asarray(float(time)),
            "@step": np.asarray(0)})
    os.replace(tmp, args.output)
    m = np.asarray(mass, np.float64)
    print(f"wrote {args.output}: N={len(m)}  M_tot={m.sum():.6g}  "
          f"t={float(time):.6g}  (use it with [ic] kind=\"file\" "
          f"file=\"{args.output}\")")


def do_export(args):
    with np.load(args.input, allow_pickle=False) as f:
        pos = np.asarray(f["particles/pos"], np.float64)
        vel = np.asarray(f["particles/vel"], np.float64)
        mass = np.asarray(f["particles/mass"], np.float64)
        ids = np.asarray(f["particles/ids"], np.int32)
        time = float(f["@time"]) if "@time" in f.files else 0.0
        units = {k.split("@", 1)[1]: f[k].item() for k in f.files
                 if k.startswith("units@")}

    ext = os.path.splitext(args.output)[1].lower()
    if ext == ".npz":
        np.savez(args.output, mass=mass, pos=pos, vel=vel, ids=ids,
                 time=np.float64(time))
    else:
        table = np.column_stack([mass, pos, vel])
        header = (f"oc_nbody_tpu snapshot t={time:.17g} N={len(mass)} "
                  f"units={units or 'code'}\n"
                  "m x y z vx vy vz")
        np.savetxt(args.output, table, header=header,
                   delimiter="," if ext == ".csv" else " ",
                   fmt="%.17g")
    print(f"wrote {args.output}: N={len(mass)}  t={time:.6g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    imp = sub.add_parser("import", help="table/npz/npy -> snapshot .npz")
    imp.add_argument("input")
    imp.add_argument("output", help="snapshot .npz path to write")
    imp.add_argument("--mass-scale", type=float, default=1.0)
    imp.add_argument("--length-scale", type=float, default=1.0)
    imp.add_argument("--velocity-scale", type=float, default=1.0)
    imp.add_argument("--time", type=float, default=None,
                     help="override the stored simulation time")
    imp.set_defaults(fn=do_import)

    exp = sub.add_parser("export", help="snapshot .npz -> .csv/.txt/.npz")
    exp.add_argument("input", help="snapshot .npz path")
    exp.add_argument("output", help=".csv / .txt / .dat / .npz to write")
    exp.set_defaults(fn=do_export)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
