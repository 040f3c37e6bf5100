"""CLI entry points and analysis scripts, in-process (SURVEY.md §2.13/§2.14)."""
import json
import os
import sys

import pytest

import oc_nbody_tpu.__main__ as cli


def _write_cfg(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "ic": {"n": 32, "seed": 1},
        "integrator": {"dt": 1.0 / 64, "eps": 1.0 / 16},
        "output": {"out_dir": str(tmp_path / "run"), "t_end": 0.25,
                   "diag_every": 0.125, "snap_every": 0.25, "stdout": False},
        "backend": "jnp",
    }))
    return str(cfg)


def test_cli_info(tmp_path, capsys):
    cfg = _write_cfg(tmp_path)
    assert cli.main(["info", cfg, "--set", "integrator.eta=0.05"]) == 0
    out = capsys.readouterr().out
    parsed = json.loads(out)
    assert parsed["integrator"]["eta"] == 0.05
    assert parsed["ic"]["n"] == 32


def test_cli_run_and_analysis(tmp_path, capsys):
    cfg = _write_cfg(tmp_path)
    assert cli.main(["run", cfg]) == 0
    run_dir = str(tmp_path / "run")
    assert os.path.exists(os.path.join(run_dir, "diagnostics.npz"))

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "analysis"))
    try:
        import plot_run
        import inspect_snapshot
        plot_run.main([run_dir, "--out", str(tmp_path / "plots.png"),
                       "--structure"])
        assert os.path.exists(str(tmp_path / "plots.png"))
        assert os.path.exists(str(tmp_path / "plots_structure.png"))
        snap = os.path.join(run_dir, "snapshot_00000.npz")
        inspect_snapshot.main([snap, "--plot", str(tmp_path / "xy.png")])
        assert os.path.exists(str(tmp_path / "xy.png"))

        import profiles
        profiles.main([snap, "--bins", "8",
                       "--save", str(tmp_path / "prof.png")])
        assert os.path.exists(str(tmp_path / "prof.png"))
        out = capsys.readouterr().out
        assert "r_half=" in out
        assert "r_core=" in out

        assert profiles.main([run_dir, "--evolution",
                              "--save", str(tmp_path / "evo.png")]) == 0
        assert os.path.exists(str(tmp_path / "evo.png"))
    finally:
        sys.path.pop(0)


def test_movie_script(tmp_path):
    cfg = _write_cfg(tmp_path)
    assert cli.main(["run", cfg]) == 0
    run_dir = str(tmp_path / "run")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "analysis"))
    try:
        import movie
        frames = str(tmp_path / "frames")
        gif = str(tmp_path / "movie.gif")
        movie.main([run_dir, "--out", gif, "--frames-dir", frames,
                    "--frame", "cluster"])
        assert os.path.exists(gif)
        assert os.path.exists(os.path.join(frames, "frame_00000.png"))
    finally:
        sys.path.pop(0)


def test_cli_bad_override(tmp_path):
    cfg = _write_cfg(tmp_path)
    with pytest.raises(KeyError):
        cli.main(["info", cfg, "--set", "integrator.bogus=1"])


def test_compare_runs_script(tmp_path):
    cfg = _write_cfg(tmp_path)
    assert cli.main(["run", cfg]) == 0
    run_dir = str(tmp_path / "run")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "analysis"))
    try:
        import compare_runs
        out = str(tmp_path / "cmp.png")
        compare_runs.main([run_dir, run_dir, "--labels", "a", "b",
                           "--columns", "dE_over_E", "KE", "--out", out])
        assert os.path.exists(out)
    finally:
        sys.path.pop(0)


def test_cli_run_with_profile(tmp_path):
    """--profile DIR captures an XProf trace (SURVEY.md §5; VERDICT A1)."""
    cfg = _write_cfg(tmp_path)
    trace_dir = str(tmp_path / "traces")
    assert cli.main(["run", cfg, "--profile", trace_dir,
                     "--set", "output.out_dir=" + str(tmp_path / "run2")]) == 0
    # jax.profiler.trace writes plugins/profile/<ts>/*.xplane.pb
    found = []
    for root, _, files in os.walk(trace_dir):
        found += [f for f in files if f.endswith((".xplane.pb", ".trace.json.gz"))]
    assert found, f"no trace artifacts under {trace_dir}"


def test_api_quickstart_example(capsys):
    """examples/api_quickstart.py — the programmatic surface mirror of the
    CLI path — runs end-to-end and conserves energy at tiny N."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    try:
        import api_quickstart
        assert api_quickstart.main(["96"]) == 0
        out = capsys.readouterr().out
        assert "dE/E_int" in out and "r_half" in out
    finally:
        sys.path.pop(0)


def test_escapers_script(tmp_path):
    """analysis/escapers.py: per-particle escape census + tail split from a
    snapshot sequence, rebuilding the potential from the embedded config."""
    cfg = tmp_path / "strip.json"
    cfg.write_text(json.dumps({
        "ic": {"kind": "king", "n": 64, "w0": 3.0, "seed": 2},
        "potential": {"kind": "milky_way"},
        "orbit": {"kind": "circular", "R0_pc": 2000.0},
        "units": {"kind": "henon", "mass_msun": 5.0e4, "length_pc": 10.0},
        "integrator": {"dt": 1.0 / 64, "eps": 1.0 / 16},
        "output": {"out_dir": str(tmp_path / "strip"), "t_end": 0.5,
                   "diag_every": 0.25, "snap_every": 0.25, "stdout": False},
        "backend": "jnp",
    }))
    assert cli.main(["run", str(cfg)]) == 0
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "analysis"))
    try:
        import escapers
        csv = str(tmp_path / "esc.csv")
        png = str(tmp_path / "esc.png")
        assert escapers.main([str(tmp_path / "strip"), "--csv", csv,
                              "--save", png]) == 0
        assert os.path.exists(png)
        header = open(csv).readline().strip()
        assert header == "id,t_escape,tail"
    finally:
        sys.path.pop(0)


def test_binaries_script(tmp_path):
    """analysis/binaries.py: bound-pair census CLI over a run with a
    primordial binary population (models/binaries.py)."""
    cfg = tmp_path / "bins.json"
    cfg.write_text(json.dumps({
        "ic": {"kind": "plummer", "n": 64, "seed": 3,
               "binary_fraction": 0.25, "binary_a_min": 4e-3,
               "binary_a_max": 2e-2},
        "integrator": {"dt": 1.0 / 256, "eps": 1.0 / 1024},
        "output": {"out_dir": str(tmp_path / "bins"), "t_end": 0.125,
                   "diag_every": 0.0625, "snap_every": 0.0625,
                   "stdout": False},
        "backend": "jnp",
    }))
    assert cli.main(["run", str(cfg)]) == 0
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "analysis"))
    try:
        import binaries as binaries_script
        csv = str(tmp_path / "pairs.csv")
        png = str(tmp_path / "ae.png")
        # census the t=0 snapshot: this coarse-dt smoke run scrambles the
        # tightest pairs dynamically (dt ~ P_min/3), which is the run's
        # problem, not the census's
        snap0 = os.path.join(str(tmp_path / "bins"), "snapshot_00000.npz")
        assert binaries_script.main([snap0, "--csv", csv,
                                     "--save", png, "--chunk", "32"]) == 0
        assert os.path.exists(png)
        header = open(csv).readline().strip()
        assert header == "id_i,id_j,a,e,e_bind,hard"
        # 16 injected pairs at a << interparticle spacing: all found
        assert sum(1 for _ in open(csv)) - 1 >= 16
        assert binaries_script.main([str(tmp_path / "bins"),
                                     "--evolution", "--chunk", "32"]) == 0
    finally:
        sys.path.pop(0)


def test_convert_script_roundtrip(tmp_path):
    """analysis/convert.py: the universal adapter. A foreign plain table
    (m x y z vx vy vz) imports into a schema-v1 snapshot that drives a
    run via ic.kind="file"; export reproduces the particle data exactly
    in both csv and npz forms."""
    import numpy as np

    rng = np.random.default_rng(3)
    n = 24
    table = np.column_stack([
        np.full(n, 1.0 / n), rng.normal(size=(n, 3)),
        0.1 * rng.normal(size=(n, 3))])
    src = tmp_path / "mcluster.dat"
    np.savetxt(src, table)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "analysis"))
    try:
        import convert
        ic_h5 = str(tmp_path / "ic.npz")
        convert.main(["import", str(src), ic_h5, "--mass-scale", "2.0"])

        # imported snapshot drives a run as a file IC
        cfg = tmp_path / "fromfile.json"
        cfg.write_text(json.dumps({
            "ic": {"kind": "file", "file": ic_h5},
            "integrator": {"dt": 1.0 / 64, "eps": 1.0 / 8},
            "output": {"out_dir": str(tmp_path / "run_file"), "t_end": 0.125,
                       "diag_every": 0.125, "snap_every": 0.125,
                       "stdout": False},
            "backend": "jnp",
        }))
        assert cli.main(["run", str(cfg)]) == 0

        # exact particle round-trip through csv and npz
        csv = str(tmp_path / "snap.csv")
        npz = str(tmp_path / "snap.npz")
        convert.main(["export", ic_h5, csv])
        convert.main(["export", ic_h5, npz])
        back = np.loadtxt(csv, delimiter=",")
        np.testing.assert_allclose(back[:, 0], 2.0 * table[:, 0], rtol=1e-7)
        np.testing.assert_array_equal(back[:, 1:4], table[:, 1:4])
        with np.load(npz) as z:
            np.testing.assert_array_equal(z["pos"], table[:, 1:4])
            np.testing.assert_array_equal(z["vel"], table[:, 4:7])
            assert z["ids"].shape == (n,)

        # npz also imports (with ids and time preserved)
        ic2 = str(tmp_path / "ic2.npz")
        convert.main(["import", npz, ic2, "--time", "1.5"])
        with np.load(ic2) as f:
            assert float(f["@time"]) == 1.5
            assert f["particles/pos"].shape == (n, 3)
    finally:
        sys.path.pop(0)
