"""Regression tests for the round-3 final-session I/O + diagnostics review."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu import diagnostics
from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.io import snapshot as snap_mod
from oc_nbody_tpu.io.snapshot import (SnapshotWriter, latest_snapshot,
                                      read_snapshot, write_snapshot)
from oc_nbody_tpu.models.plummer import plummer


def _state(n=32, seed=0):
    return plummer(n, jax.random.PRNGKey(seed))


def test_latest_snapshot_integer_order(tmp_path):
    """Lexicographic order breaks past index 99999: 'snapshot_100000.npz' <
    'snapshot_99999.npz' as strings — resume must use the parsed index."""
    st = _state()
    for idx in (99999, 100000):
        write_snapshot(str(tmp_path / f"snapshot_{idx:05d}.npz"), st)
    assert latest_snapshot(str(tmp_path)).endswith("snapshot_100000.npz")


def test_corrupt_diagnostics_does_not_block_resume(tmp_path, capsys):
    """A corrupted diagnostics table (e.g. damaged on disk) must be moved
    aside, not crash the resume path forever."""
    w = SnapshotWriter(str(tmp_path), async_io=False)
    (tmp_path / "diagnostics.npz").write_bytes(b"not an npz file")
    w.truncate_diagnostics(1.0)  # must not raise
    assert not (tmp_path / "diagnostics.npz").exists()
    assert (tmp_path / "diagnostics.npz.corrupt").exists()


def test_async_write_error_surfaces_at_next_write(tmp_path, monkeypatch):
    w = SnapshotWriter(str(tmp_path), async_io=True)
    st = _state()

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(snap_mod, "_write_file", boom)
    w.write(0, st)          # failure is queued
    w._pending[0].exception(timeout=30)  # let the worker finish
    with pytest.raises(OSError, match="disk full"):
        w.write(1, st)      # surfaced HERE, not at end-of-run flush


def test_flush_waits_all_futures_before_raising(tmp_path):
    """flush() must wait for ALL queued writes (e.g. the emergency
    snapshot queued after a failure) before re-raising the first error —
    seed the pending queue directly to model both writes already
    in flight (write()'s own early reap is covered above)."""
    w = SnapshotWriter(str(tmp_path), async_io=True)
    st = _state()

    def boom():
        raise OSError("disk full")

    done = {"second": False}

    def second():
        done["second"] = True
        return write_snapshot(str(tmp_path / "snapshot_00001.npz"), st)

    w._pending.append(w._pool.submit(boom))
    w._pending.append(w._pool.submit(second))
    with pytest.raises(OSError, match="disk full"):
        w.flush()
    # the second write completed (was not abandoned by an early re-raise)
    assert done["second"]
    assert os.path.exists(str(tmp_path / "snapshot_00001.npz"))
    assert w._pending == []


def test_schema_version_rejected(tmp_path):
    path = str(tmp_path / "snapshot_00000.npz")
    write_snapshot(path, _state())
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["@schema_version"] = np.asarray(99)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="schema v99"):
        read_snapshot(path)


def test_reset_outputs_removes_orphan_tmp(tmp_path):
    w = SnapshotWriter(str(tmp_path), async_io=False)
    (tmp_path / "snapshot_00042.npz.tmp").write_bytes(b"partial")
    w.reset_outputs()
    assert not (tmp_path / "snapshot_00042.npz.tmp").exists()


def test_tidal_radius_nonpositive_coefficient_is_inf():
    r = diagnostics.tidal_radius(jnp.asarray(1.0), jnp.asarray(-0.5), 1.0)
    assert np.isinf(float(r))
    r = diagnostics.tidal_radius(jnp.asarray(1.0), jnp.asarray(0.0), 1.0)
    assert np.isinf(float(r))
    r = diagnostics.tidal_radius(jnp.asarray(1.0), jnp.asarray(1.0), 1.0)
    assert float(r) == pytest.approx(1.0)


def test_lagrangian_radii_zero_mask_is_nan():
    st = _state()
    rl = diagnostics.lagrangian_radii(st, mask=jnp.zeros(st.mass.shape[0]))
    assert np.isnan(np.asarray(rl)).all()
    rl = diagnostics.lagrangian_radii(st)  # no mask: finite as before
    assert np.isfinite(np.asarray(rl)).all()


def test_compute_all_single_potential_pass():
    """Isolated cluster: energies() and the bound-mass energy cut must
    share ONE pairwise-potential evaluation."""
    st = _state(n=48)
    force = make_force_model(eps=0.05, backend="jnp")
    calls = {"n": 0}

    class Counting:
        def __getattr__(self, k):
            v = getattr(force, k)
            if k == "accel_potential":
                def wrapped(*a, **kw):
                    calls["n"] += 1
                    return v(*a, **kw)
                return wrapped
            if k == "at_time":
                # compute_all rebinds force = force.at_time(t) first; keep
                # the counting proxy alive across that (no-op) rebinding
                return lambda t: self
            return v

    row = diagnostics.compute_all(st, Counting())
    assert calls["n"] == 1, calls
    assert np.isfinite(float(row["E_tot"]))
