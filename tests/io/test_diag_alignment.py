"""Diagnostics-table row alignment across schema changes (code-review
round-3 finding): columns may appear mid-series (resume under newer code)
AND disappear mid-series (a diagnostics flag turned off, or resume under
older code) — every dataset must keep one row per diagnostics boundary,
NaN where the column wasn't computed.
"""
import numpy as np

from oc_nbody_tpu.io.snapshot import SnapshotWriter


def _writer(tmp_path):
    return SnapshotWriter(str(tmp_path))


def test_column_appears_mid_series(tmp_path):
    w = _writer(tmp_path)
    w.append_diagnostics({"time": 0.0, "E": 1.0})
    w.append_diagnostics({"time": 1.0, "E": 1.1, "r_core": 0.5})
    with np.load(str(tmp_path / "diagnostics.npz")) as f:
        assert f["time"].shape == f["E"].shape == f["r_core"].shape == (2,)
        rc = np.asarray(f["r_core"])
        assert np.isnan(rc[0]) and rc[1] == 0.5


def test_column_disappears_and_reappears(tmp_path):
    w = _writer(tmp_path)
    w.append_diagnostics({"time": 0.0, "r_core": 0.5})
    w.append_diagnostics({"time": 1.0})              # flag off / old code
    w.append_diagnostics({"time": 2.0, "r_core": 0.3})
    with np.load(str(tmp_path / "diagnostics.npz")) as f:
        assert f["time"].shape == f["r_core"].shape == (3,)
        rc = np.asarray(f["r_core"])
        assert rc[0] == 0.5 and np.isnan(rc[1]) and rc[2] == 0.3
        assert list(np.asarray(f["time"])) == [0.0, 1.0, 2.0]


def test_legacy_misaligned_table_is_nan_gapped(tmp_path):
    # a pre-fix table where one column is short: the next append realigns
    w = _writer(tmp_path)
    path = str(tmp_path / "diagnostics.npz")
    with open(path, "wb") as f:
        np.savez(f, time=np.array([0.0, 1.0]), r_core=np.array([0.5]))
    w.append_diagnostics({"time": 2.0, "r_core": 0.2})
    with np.load(path) as f:
        rc = np.asarray(f["r_core"])
        assert rc.shape == (3,)
        assert rc[0] == 0.5 and np.isnan(rc[1]) and rc[2] == 0.2
