#!/usr/bin/env python
"""Smoke test of the main path on the GPU, in one process.

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --mesh4   # the four-GPU sharded phase, and no other

Phases (each prints one line with its wall time and what it measured; any
failure raises, so the script exits non-zero and prints no result line):

  1. device: JAX must report a GPU (the script never carries on on the
     CPU); prints the card's name and power limit as nvidia-smi gives them.
  2. kernels: every pairwise sweep on the main path, compiled for the card,
     against the plain reference (``ops/gravity.py`` in float64 under
     "highest" matmul precision, computed on the card), at the widths of
     the configs that use them: accel and accel+phi at N=65,536
     (north_star_65k_orbit), accel+jerk at N=16,384 (c3_hermite_16k_kroupa),
     and accel+jerk on 512 active rows against 32,768 sources (the block
     integrator's accel_jerk_on_rows, c4_block_32k_eccentric). Metric: the
     per-row relative error |a - a_ref| / |a_ref|, max and median. Then the
     df32 error-free-transformation exactness checks and the extended/df32
     tier-error checks of tests/unit/test_df32.py, at N=8,192 (binaries_8k
     width), with the tests' thresholds.
  3. end to end: ``python -m oc_nbody_tpu run
     configs/north_star_65k_orbit.toml`` at its full N=65,536 (KDK, Milky
     Way field, diagnostics), with t_end cut from 2 crossing times (5,793
     steps) to 32 steps: diagnostics every 8 steps, a snapshot at step 16.
     A second run stops at step 16 and resumes to step 32; its state and
     diagnostics must equal the straight run's bit for bit. Every row's
     |dE/E_int| must stay below the config's 1e-6.
  4. Hermite: ``run configs/c3_hermite_16k_kroupa.toml`` at N=16,384 with
     t_end cut from 10 to 1/64 (a few adaptive steps).

  --mesh4: c5_131k_sharded at N=131,072 on 4 GPUs: one force evaluation
     for each of allgather, ring and halfring against the single-device
     f64 reference on the same host, the state's placement across the four
     cards, then 4 KDK steps of the ring mode through the CLI (t_end cut
     from 10 to 4/1024).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Per-row relative error bounds (max, median) of the f32 sweeps against
# the f64 reference: twice the jnp f32 path's own error in the same
# comparison on the CPU at the same N (kernel_errors("jnp"), XLA:CPU,
# numbers in the comments), and never looser than 1e-4 for the max.
TOL = {
    # CPU jnp: max 5.659e-05, median 7.691e-08
    ("accel_65536", "accel"): (1e-4, 1.54e-7),
    ("accel_phi_65536", "accel"): (1e-4, 1.54e-7),
    # CPU jnp: max 2.913e-07, median 4.816e-08
    ("accel_phi_65536", "phi"): (5.83e-7, 9.63e-8),
    # CPU jnp: max 2.517e-05, median 7.714e-08
    ("accel_jerk_16384", "accel"): (5.03e-5, 1.54e-7),
    # CPU jnp: max 3.122e-05, median 5.111e-07
    ("accel_jerk_16384", "jerk"): (6.24e-5, 1.02e-6),
    # CPU jnp: max 1.812e-06, median 9.257e-08
    ("active_512x32768", "accel"): (3.62e-6, 1.85e-7),
    # CPU jnp: max 1.012e-05, median 7.613e-07
    ("active_512x32768", "jerk"): (2.02e-5, 1.52e-6),
}
ENERGY_BOUND = 1e-6   # north_star_65k_orbit: |dE/E_int| per diagnostics row


def log(phase, t0, **fields):
    items = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] wall={time.perf_counter() - t0:.3f}s {items}",
          flush=True)


def card_lines():
    """nvidia-smi's name and power limit of every visible card (a child
    process that does not use JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def rel_rows(x, ref):
    """(max, median) over rows of |x - ref| / |ref| (vector rows by norm)."""
    import numpy as np
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if ref.ndim == 1:
        e = np.abs(x - ref) / np.abs(ref)
    else:
        e = np.linalg.norm(x - ref, axis=1) / np.linalg.norm(ref, axis=1)
    return float(np.max(e)), float(np.median(e))


def load_scene(name, **overrides):
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.scene import build_scene
    cfg = apply_overrides(load_config(os.path.join(HERE, "configs", name)),
                          [f"{k}={v}" for k, v in overrides.items()])
    return cfg, build_scene(cfg)


# --------------------------------------------------------------------------
# phase 2: kernels against the f64 reference
# --------------------------------------------------------------------------

def kernel_errors(backend="auto", n_accel=65536, n_jerk=16384,
                  n_rows=512, n_src=32768):
    """{(comparison, output): (max, median)} of ``backend``'s f32 sweeps
    against the f64 reference, on the configs' own initial conditions."""
    import jax
    import jax.numpy as jnp
    from oc_nbody_tpu.ops import gravity
    from oc_nbody_tpu.ops.backend import pair_ops

    ops = pair_ops(backend)
    f64 = jnp.float64
    out = {}

    def ref64(fn, *args):
        with jax.default_matmul_precision("highest"):
            return jax.jit(functools.partial(fn, compute_dtype=f64,
                                             chunk=256))(*args)

    cfg, sc = load_scene("north_star_65k_orbit.toml", **{"ic.n": n_accel})
    st, eps, G = sc.state, cfg.integrator.eps, float(sc.force.G)
    a_ref, p_ref = ref64(gravity.accel_potential, st.pos, st.mass, eps, G)
    a = jax.jit(ops.accel)(st.pos, st.mass, eps, G)
    out[("accel_%d" % n_accel, "accel")] = rel_rows(a, a_ref)
    a, p = jax.jit(ops.accel_potential)(st.pos, st.mass, eps, G)
    out[("accel_phi_%d" % n_accel, "accel")] = rel_rows(a, a_ref)
    out[("accel_phi_%d" % n_accel, "phi")] = rel_rows(p, p_ref)

    cfg, sc = load_scene("c3_hermite_16k_kroupa.toml", **{"ic.n": n_jerk})
    st, eps, G = sc.state, cfg.integrator.eps, float(sc.force.G)
    a_ref, j_ref = ref64(gravity.accel_jerk, st.pos, st.vel, st.mass, eps, G)
    a, j = jax.jit(ops.accel_jerk)(st.pos, st.vel, st.mass, eps, G)
    out[("accel_jerk_%d" % n_jerk, "accel")] = rel_rows(a, a_ref)
    out[("accel_jerk_%d" % n_jerk, "jerk")] = rel_rows(j, j_ref)

    cfg, sc = load_scene("c4_block_32k_eccentric.toml", **{"ic.n": n_src})
    st = sc.state
    fm = dataclasses.replace(sc.force, external=None, friction=None,
                             backend=backend)
    idx = jax.random.choice(jax.random.PRNGKey(4), n_src, (n_rows,),
                            replace=False)
    a, j = jax.jit(fm.accel_jerk_on_rows)(st.pos[idx], st.vel[idx],
                                          st.pos, st.vel, st.mass)
    c, vc = jnp.mean(st.pos, axis=0), jnp.mean(st.vel, axis=0)
    with jax.default_matmul_precision("highest"):
        a_ref, j_ref = jax.jit(gravity.accel_jerk_rows, static_argnums=7)(
            st.pos[idx] - c, st.vel[idx] - vc, st.pos - c, st.vel - vc,
            st.mass, jnp.asarray(cfg.integrator.eps, f64),
            jnp.asarray(fm.G, f64), 256)
    name = "active_%dx%d" % (n_rows, n_src)
    out[(name, "accel")] = rel_rows(a, a_ref)
    out[(name, "jerk")] = rel_rows(j, j_ref)
    return out


def df32_checks(n=8192):
    """tests/unit/test_df32.py's exactness and tier-error checks, at N."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from oc_nbody_tpu.ops import df32, gravity

    res = {}
    a = jax.random.normal(jax.random.PRNGKey(0), (4096,), jnp.float32)
    b = jax.random.normal(jax.random.PRNGKey(1), (4096,), jnp.float32) * 1e3
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s, e = jax.jit(df32.two_sum)(a, b)
    assert np.array_equal(np.asarray(s, np.float64) + np.asarray(e, np.float64),
                          a64 + b64), "two_sum not exact"
    p, e = jax.jit(df32.two_prod)(a, b)
    assert np.array_equal(np.asarray(p, np.float64) + np.asarray(e, np.float64),
                          a64 * b64), "two_prod not exact"
    x = jnp.geomspace(1e-6, 1e3, 4096).astype(jnp.float32)
    h, lo = jax.jit(lambda x: df32.df_rsqrt((x, jnp.zeros_like(x))))(x)
    ref = np.asarray(x, np.float64) ** -0.5
    got = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    res["eft_rsqrt"] = float(np.max(np.abs(got - ref) / ref))
    assert res["eft_rsqrt"] < 1e-12, res

    kp, kv, km = jax.random.split(jax.random.PRNGKey(0), 3)
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    pos = pos.at[50:100].set(
        pos[:50] + 1e-5 * jax.random.normal(km, (50, 3), jnp.float64))
    vel = 0.3 * jax.random.normal(kv, (n, 3), jnp.float64)
    mass = jax.random.uniform(km, (n,), jnp.float64, 0.5, 1.5) / n

    def ref64(fn, *args):
        with jax.default_matmul_precision("highest"):
            return fn(*args, compute_dtype=jnp.float64, chunk=256)

    def err(x, r):
        return float(jnp.max(jnp.linalg.norm(x - r, axis=1))
                     / jnp.max(jnp.linalg.norm(r, axis=1)))

    eps = 1e-4
    aref = ref64(gravity.accel, pos, mass, eps, 1.0)
    res["accel_ext"] = err(df32.accel_extended(pos, mass, eps, chunk=256),
                           aref)
    res["accel_df"] = err(df32.accel_df(pos, mass, eps, chunk=256), aref)
    res["accel_f32"] = err(gravity.accel(pos, mass, eps, chunk=256), aref)
    assert res["accel_ext"] < 2e-5 and res["accel_df"] < 1e-8, res
    assert res["accel_f32"] > 10 * res["accel_ext"] > 1e4 * res["accel_df"], \
        res

    pos_far = jax.random.normal(kp, (n, 3), jnp.float64)
    _, pref = ref64(gravity.accel_potential, pos_far, mass, 0.05, 1.3)
    self_term = gravity.self_phi(mass, jnp.float64(0.05), jnp.float64(1.3))
    for name, fn, tol in (("phi_ext", df32.accel_potential_extended, 1e-6),
                          ("phi_df", df32.accel_potential_df, 1e-10)):
        _, phi = fn(pos_far, mass, 0.05, 1.3, chunk=256)
        res[name] = float(jnp.max(jnp.abs(phi + self_term - pref))
                          / jnp.max(jnp.abs(pref)))
        assert res[name] < tol, (name, res)

    _, jref = ref64(gravity.accel_jerk, pos, vel, mass, eps, 1.0)
    res["jerk_ext"] = err(df32.accel_jerk_extended(pos, vel, mass, eps,
                                                   chunk=256)[1], jref)
    res["jerk_df"] = err(df32.accel_jerk_df(pos, vel, mass, eps,
                                            chunk=256)[1], jref)
    assert res["jerk_ext"] < 5e-5 and res["jerk_df"] < 1e-8, res
    return res


# --------------------------------------------------------------------------
# phases 3-4 and the mesh phase: the CLI
# --------------------------------------------------------------------------

def cli(config, out_dir, *sets, resume=False):
    """``python -m oc_nbody_tpu run`` in-process; returns its wall time."""
    from oc_nbody_tpu.__main__ import main as cli_main
    args = ["run", os.path.join(HERE, "configs", config),
            "--set", f"output.out_dir={out_dir}"]
    for s in sets:
        args += ["--set", s]
    if resume:
        args.append("--resume")
    t0 = time.perf_counter()
    assert cli_main(args) == 0
    return time.perf_counter() - t0


def fresh_dir(name):
    path = os.path.join(HERE, "out", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def final_state(out_dir):
    from oc_nbody_tpu.io.snapshot import (SnapshotWriter, latest_snapshot,
                                          read_snapshot)
    snap = read_snapshot(latest_snapshot(out_dir))
    return snap, SnapshotWriter(out_dir).read_diagnostics()


def phase_north_star(n=None, bound=ENERGY_BOUND, backend="auto"):
    """``n`` cuts N for a rehearsal on the CPU (with a ``bound`` to suit);
    the smoke test runs the config's own N and bound."""
    import numpy as np
    dt = 1.0 / 1024                   # the config's own step
    sets = [f"output.diag_every={8 * dt!r}", f"output.snap_every={16 * dt!r}",
            f"backend={backend}"]
    sets += [f"ic.n={n}"] if n else []
    straight = fresh_dir("north_star")
    wall = cli("north_star_65k_orbit.toml", straight,
               f"output.t_end={32 * dt!r}", *sets)
    legs = fresh_dir("north_star_resume")
    cli("north_star_65k_orbit.toml", legs, f"output.t_end={16 * dt!r}", *sets)
    cli("north_star_65k_orbit.toml", legs, f"output.t_end={32 * dt!r}", *sets,
        resume=True)
    snap_a, diag_a = final_state(straight)
    snap_b, diag_b = final_state(legs)
    steps = (snap_a.attrs["step"], snap_b.attrs["step"])
    assert steps == (32, 32), steps
    for name in ("pos", "vel"):
        a = np.asarray(getattr(snap_a.state, name))
        b = np.asarray(getattr(snap_b.state, name))
        assert np.array_equal(a, b), (
            f"resume not bitwise in {name}: max |diff| "
            f"{np.max(np.abs(a - b))}")
    for k in diag_a:
        if k == "wall_s":     # the host clock, not simulation state
            continue
        assert np.array_equal(np.asarray(diag_a[k]), np.asarray(diag_b[k])), \
            f"resume not bitwise in diagnostics column {k}"
    de = np.abs(np.asarray(diag_a["dE_over_E_int"]))
    assert de.max() < bound, de
    return wall, de


def phase_hermite(n=None):
    import numpy as np
    out = fresh_dir("c3_hermite")
    t = 1.0 / 64
    wall = cli("c3_hermite_16k_kroupa.toml", out, f"output.t_end={t!r}",
               f"output.diag_every={t!r}", f"output.snap_every={t!r}",
               *([f"ic.n={n}"] if n else []))
    snap, diag = final_state(out)
    steps, time_ = snap.attrs["step"], float(snap.state.time)
    assert steps > 0 and abs(time_ - t) < 1e-12, (steps, time_)
    assert np.all(np.isfinite(np.asarray(snap.state.pos)))
    return wall, steps, float(np.max(np.abs(diag["dE_over_E_int"])))


def phase_mesh4(n=131072, n_dev=4):
    """Sharded modes on ``n_dev`` devices against the single-device f64
    reference; placement of the sharded state; KDK steps via the CLI."""
    import jax
    import jax.numpy as jnp
    from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
    from oc_nbody_tpu.ops import gravity
    from oc_nbody_tpu.ops.backend import pair_ops
    from oc_nbody_tpu.parallel import make_mesh, make_sharded_force

    assert len(jax.devices()) >= n_dev, f"needs {n_dev} devices"
    cfg, sc = load_scene("c5_131k_sharded.toml",
                         **{"ic.n": n, "mesh.n_devices": 1})
    st, eps, G = sc.state, cfg.integrator.eps, float(sc.force.G)
    with jax.default_matmul_precision("highest"):
        a_ref = jax.jit(functools.partial(
            gravity.accel, compute_dtype=jnp.float64, chunk=256))(
                st.pos, st.mass, eps, G)
    res = {"single": rel_rows(jax.jit(pair_ops("auto").accel)(
        st.pos, st.mass, eps, G), a_ref)}
    mesh = make_mesh(n_dev)
    tol = TOL[("accel_65536", "accel")]
    for mode in ("allgather", "ring", "halfring"):
        sf = make_sharded_force(eps=eps, G=G, mesh=mesh, mode=mode)
        res[mode] = rel_rows(jax.jit(sf.accel)(st.pos, st.mass), a_ref)
        assert res[mode][0] < tol[0] and res[mode][1] < tol[1], (mode, res)
    # placement: one sharded KDK step leaves the state spread over the
    # mesh, each device holding its own rows
    sf = make_sharded_force(eps=eps, G=G, external=sc.force.external,
                            mesh=mesh, mode="ring")
    kdk = LeapfrogKDK(force=sf, dt=cfg.integrator.dt)
    carry = jax.jit(kdk.step)(kdk.init(st))
    pos = carry.state.pos
    shards = {s.device.id: s.data.shape for s in pos.addressable_shards}
    res["placement"] = shards
    assert len(pos.sharding.device_set) == n_dev, shards
    assert all(shape[0] < n for shape in shards.values()), shards
    dt = cfg.integrator.dt
    out = fresh_dir("c5_mesh4")
    wall = cli("c5_131k_sharded.toml", out,
               f"ic.n={n}", f"mesh.n_devices={n_dev}", "mesh.mode=ring",
               f"output.t_end={4 * dt!r}", f"output.diag_every={2 * dt!r}",
               f"output.snap_every={4 * dt!r}")
    snap, diag = final_state(out)
    assert snap.attrs["step"] == 4
    assert bool(jnp.all(jnp.isfinite(snap.state.pos)))
    res["cli_dE_over_E_int"] = float(max(abs(x) for x in
                                         diag["dE_over_E_int"]))
    return wall, res


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run the four-GPU sharded phase only")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    import jax
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import oc_nbody_tpu  # noqa: F401  (fails outside a checkout)

    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    log("device", t0, kind=repr(dev["kind"]), count=dev["count"],
        jax=jax.__version__, card=repr(cards[0]))

    if args.mesh4:
        t0 = time.perf_counter()
        wall, res = phase_mesh4()
        log("mesh4", t0, card=repr(cards[0]), cli_wall=f"{wall:.3f}s",
            **{k: v for k, v in res.items()})
    else:
        t0 = time.perf_counter()
        errs = kernel_errors("auto")
        for key, (mx, med) in errs.items():
            bound = TOL[key]
            assert mx < bound[0] and med < bound[1], (key, mx, med, bound)
        log("kernels", t0, card=repr(cards[0]), **{
            f"{a}.{b}": f"max={mx:.3e},median={med:.3e}"
            for (a, b), (mx, med) in errs.items()})
        t0 = time.perf_counter()
        res = df32_checks()
        log("df32", t0, card=repr(cards[0]),
            **{k: f"{v:.3e}" for k, v in res.items()})
        t0 = time.perf_counter()
        wall, de = phase_north_star()
        peak = devs[0].memory_stats()["peak_bytes_in_use"]
        log("north_star", t0, card=repr(cards[0]),
            run_wall=f"{wall:.3f}s", max_abs_dE_over_E_int=f"{de.max():.3e}",
            rows=len(de), resume="bitwise", peak_bytes_in_use=peak)
        t0 = time.perf_counter()
        wall, steps, de = phase_hermite()
        log("hermite", t0, card=repr(cards[0]), run_wall=f"{wall:.3f}s",
            steps=steps, max_abs_dE_over_E_int=f"{de:.3e}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
