"""Snapshot / checkpoint I/O and the diagnostics time-series table.

Capability parity: SURVEY.md §2.10 — the reference writes snapshots that its
analysis scripts read back (BASELINE.json:5 "snapshot I/O"). The exact
reference schema is unknowable (empty tree, SURVEY.md §0), so this schema is
defined cleanly and documented in docs/SNAPSHOT_SCHEMA.md; an adapter can be
added if the reference ever materialises.

Snapshots double as checkpoints (SURVEY.md §5 failure-recovery): they carry
the full integrator aux state (accelerations, jerks, per-particle timestep
state, step counter) so a resumed run continues bit-identically. Every file
is written atomically (temp file + os.replace) so a crash mid-write never
corrupts the latest checkpoint or the diagnostics table.

Container: one numpy ``.npz`` archive per file (numpy only — no HDF5
library), read with ``allow_pickle=False``. Schema v1, flattened: ``/``
separates a group from an array, ``@`` an owner from an attribute.
  particles/{pos,vel,mass,ids}       f64 (N,3), f64 (N,3), f32 (N,), i32 (N,)
  particles@n
  integrator/<aux arrays>            integrator-kind-specific
  integrator@kind
  units@{length_pc,mass_msun,time_myr}           (optional)
  @schema_version, @time, @step, @config_json (optional), @rng_key, ...
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from oc_nbody_tpu.state import ParticleState, make_state
from oc_nbody_tpu.utils.units import UnitSystem

SCHEMA_VERSION = 1


@dataclasses.dataclass
class Snapshot:
    state: ParticleState
    aux: dict                      # integrator aux arrays (numpy)
    integrator_kind: Optional[str]
    units: Optional[UnitSystem]
    attrs: dict                    # root attrs (time, step, config_json, ...)


def _materialize(state, aux, attrs):
    """Fetch everything to host numpy (device work is done after this)."""
    data = {
        "pos": np.asarray(state.pos, np.float64),
        "vel": np.asarray(state.vel, np.float64),
        "mass": np.asarray(state.mass, np.float32),
        "ids": np.asarray(state.ids, np.int32),
    }
    aux_np = {k: np.asarray(v) for k, v in (aux or {}).items()}
    attrs_np = dict(attrs or {})
    attrs_np["time"] = float(state.time)
    return data, aux_np, attrs_np


def write_npz(path: str, arrays: dict) -> str:
    """Atomically write ``arrays`` (name -> array-like) as one .npz."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)
    return path


def read_npz(path: str) -> dict:
    """Every array of an .npz written by ``write_npz`` (0-d arrays stay
    0-d; ``scalar()`` unwraps them)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def scalar(v):
    """A 0-d array as its Python value (str, int, float); others as-is."""
    v = np.asarray(v)
    return v.item() if v.ndim == 0 else v


def _write_file(path, data, aux_np, integrator_kind, units, attrs_np):
    arrays = {f"particles/{k}": data[k] for k in ("pos", "vel", "mass",
                                                 "ids")}
    arrays["particles@n"] = data["pos"].shape[0]
    if integrator_kind is not None:
        arrays["integrator@kind"] = integrator_kind
    for k, v in aux_np.items():
        arrays[f"integrator/{k}"] = v
    if units is not None:
        for k, v in units.as_dict().items():
            arrays[f"units@{k}"] = v
    arrays["@schema_version"] = SCHEMA_VERSION
    for k, v in attrs_np.items():
        if isinstance(v, (dict, list)):
            v = json.dumps(v)
        arrays[f"@{k}"] = v
    return write_npz(path, arrays)


def write_snapshot(
    path: str,
    state: ParticleState,
    aux: Optional[dict] = None,
    integrator_kind: Optional[str] = None,
    units: Optional[UnitSystem] = None,
    attrs: Optional[dict] = None,
) -> str:
    """Atomically write a snapshot; returns the final path."""
    data, aux_np, attrs_np = _materialize(state, aux, attrs)
    return _write_file(path, data, aux_np, integrator_kind, units, attrs_np)


def read_snapshot(path: str, state_dtype=jnp.float64) -> Snapshot:
    z = read_npz(path)
    version = int(scalar(z.get("@schema_version", 1)))
    if version > SCHEMA_VERSION:
        # partially-matching groups from a future schema would restore
        # silently wrong integrator state — reject instead
        raise ValueError(
            f"snapshot {path!r} has schema v{version}; this reader "
            f"understands up to v{SCHEMA_VERSION}")
    state = make_state(
        pos=z["particles/pos"],
        vel=z["particles/vel"],
        mass=z["particles/mass"],
        ids=z["particles/ids"],
        time=float(scalar(z["@time"])),
        state_dtype=state_dtype,
    )
    kind = scalar(z["integrator@kind"]) if "integrator@kind" in z else None
    aux = {k[len("integrator/"):]: v for k, v in z.items()
           if k.startswith("integrator/")}
    units = None
    unit_attrs = {k[len("units@"):]: scalar(v) for k, v in z.items()
                  if k.startswith("units@")}
    if unit_attrs:
        units = UnitSystem.from_dict(unit_attrs)
    attrs = {k[1:]: scalar(v) for k, v in z.items() if k.startswith("@")}
    return Snapshot(state=state, aux=aux, integrator_kind=kind,
                    units=units, attrs=attrs)


def _snapshot_index(path: str) -> int:
    try:
        return int(os.path.basename(path).rsplit("_", 1)[1].split(".")[0])
    except (IndexError, ValueError):
        return -1


def latest_snapshot(out_dir: str) -> Optional[str]:
    """Most recent valid snapshot file in a run directory (for resume).

    Ordered by the PARSED index: lexicographic order breaks past index
    99999 ("snapshot_100000.npz" < "snapshot_99999.npz"), which would
    resume from an older state and then overwrite the true latest."""
    paths = sorted(glob.glob(os.path.join(out_dir, "snapshot_*.npz")),
                   key=_snapshot_index)
    for p in reversed(paths):
        try:
            with np.load(p, allow_pickle=False) as z:
                if "particles/pos" in z.files:
                    return p
        except (OSError, ValueError, zipfile.BadZipFile):
            continue
    return None


class SnapshotWriter:
    """Numbered snapshots plus an appendable diagnostics table in a run dir.

    Diagnostics go to ``diagnostics.npz`` as one float64 1-D array per
    scalar column (SURVEY.md §5 metrics/observability), rewritten
    atomically at every append.
    """

    def __init__(self, out_dir: str, units: Optional[UnitSystem] = None,
                 config_json: Optional[str] = None, async_io: bool = True):
        self.out_dir = out_dir
        self.units = units
        self.config_json = config_json
        os.makedirs(out_dir, exist_ok=True)
        self._diag_path = os.path.join(out_dir, "diagnostics.npz")
        # one writer thread: snapshot writes overlap the next superstep on
        # device; ordering is preserved, atomicity unchanged
        self._pool = ThreadPoolExecutor(max_workers=1) if async_io else None
        self._pending = []

    def snapshot_path(self, index: int) -> str:
        return os.path.join(self.out_dir, f"snapshot_{index:05d}.npz")

    def write(self, index: int, state: ParticleState, aux=None,
              integrator_kind=None, step: int = 0, rng_key=None,
              extra_attrs=None) -> str:
        attrs = {"step": int(step)}
        if extra_attrs:
            # driver-level checkpoint scalars (e.g. the cumulative
            # stellar-evolution energy jump E_sev_cum) that must survive a
            # resume even though diagnostics-row truncation drops the row
            # written AT the checkpoint time (run.py resume path)
            attrs.update(extra_attrs)
        if self.config_json is not None:
            attrs["config_json"] = self.config_json
        if rng_key is not None:
            # stored as a uint32 key-data array
            attrs["rng_key"] = np.asarray(rng_key)
        path = self.snapshot_path(index)
        data, aux_np, attrs_np = _materialize(state, aux, attrs)
        if self._pool is None:
            return _write_file(path, data, aux_np, integrator_kind,
                               self.units, attrs_np)
        # reap already-completed writes first: a failed write (disk
        # full, permissions) must surface at the NEXT snapshot, not hours
        # later at the end-of-run flush
        for fut in [f for f in self._pending if f.done()]:
            self._pending.remove(fut)
            fut.result()  # re-raises the write error, if any
        fut = self._pool.submit(_write_file, path, data, aux_np,
                                integrator_kind, self.units, attrs_np)
        self._pending.append(fut)
        return path

    def flush(self) -> None:
        """Wait for ALL queued snapshot writes, then re-raise the first
        error (re-raising eagerly would abandon later futures mid-write —
        e.g. the emergency snapshot queued after a NaN abort)."""
        pending, self._pending = self._pending, []
        first_err = None
        for fut in pending:
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def append_diagnostics(self, row: dict) -> None:
        table = self.read_diagnostics()
        # columns appearing mid-series (resume across a code version that
        # added diagnostics) are NaN-backfilled, and columns the current
        # row does NOT carry (a flag turned off on resume) are NaN-padded
        # — every column leaves this call at the same length, so the whole
        # table stays row-aligned in time
        n_prev = max((v.shape[0] for v in table.values()), default=0)
        out = {}
        for k in set(table) | set(row):
            old = table.get(k, np.zeros((0,), np.float64))
            col = np.full((n_prev + 1,), np.nan)
            col[:old.shape[0]] = old
            if k in row:
                col[-1] = float(np.asarray(jax.device_get(row[k]),
                                           np.float64))
            out[k] = col
        write_npz(self._diag_path, out)

    def truncate_diagnostics(self, t_resume: float, atol: float = 1e-9) -> None:
        """Drop rows with time >= t_resume (strictly before the resume time).

        A crash (or a resume from an older snapshot) leaves diagnostics rows
        written AFTER the checkpoint being restored; without truncation the
        resumed run re-appends overlapping times and the series becomes
        non-monotonic (ADVICE round-1, medium). The resumed driver re-emits
        its own row at t_resume, so rows at >= t_resume - atol are dropped.
        """
        if not os.path.exists(self._diag_path):
            return
        try:
            table = self.read_diagnostics()
        except (OSError, ValueError, zipfile.BadZipFile):
            # the snapshot checkpoint is the authoritative state, so resume
            # must proceed past an unreadable table — move it aside and
            # start fresh
            corrupt = self._diag_path + ".corrupt"
            os.replace(self._diag_path, corrupt)
            print(f"warning: diagnostics table unreadable; moved to "
                  f"{corrupt} (resume continues from the snapshot)")
            return
        if "time" not in table:
            return
        mask = table["time"] < t_resume - atol
        keep = int(mask.nonzero()[0][-1] + 1) if mask.any() else 0
        write_npz(self._diag_path, {k: v[:keep] for k, v in table.items()})

    def has_outputs(self) -> bool:
        """True if out_dir holds any diagnostics or snapshot files."""
        if os.path.exists(self._diag_path):
            return True
        return any(
            name.startswith("snapshot_") and name.endswith(".npz")
            for name in os.listdir(self.out_dir))

    def reset_outputs(self) -> None:
        """Remove a previous run's diagnostics and snapshots from out_dir.

        A FRESH (non-resume) run into an existing directory must not leave
        stale artifacts: appended diagnostics rows make the time series
        repeat from t=0 (duplicated times corrupt plots/drift analysis),
        and leftover higher-index ``snapshot_*.npz`` from a longer previous
        run would be picked up by ``latest_snapshot`` on a later --resume,
        silently resuming the OLD run."""
        if os.path.exists(self._diag_path):
            os.remove(self._diag_path)
        for name in os.listdir(self.out_dir):
            if name.startswith("snapshot_") and name.endswith(
                    (".npz", ".npz.tmp")):  # .tmp: orphan of a crashed write
                os.remove(os.path.join(self.out_dir, name))

    def read_diagnostics(self) -> dict:
        if not os.path.exists(self._diag_path):
            return {}
        return read_npz(self._diag_path)
