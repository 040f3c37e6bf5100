"""Regression tests for the round-2 VERDICT/ADVICE findings (round 3).

Each test pins one previously-latent defect:
  * run() mutated cfg.output in place (VERDICT W4)
  * mode='rdma' + backend='jnp' failed late with a Mosaic error (W6)
  * Hermite4.restore accepted a checkpointed dt above dt_max (W7)
  * Hermite4 quantize used float 2.0**(-k) — not bit-exact on every backend
    emulated f64 (VERDICT Missing #4; block.py's int grid applied)
  * --resume with no snapshot wiped existing outputs (ADVICE low)
  * accel_jerk_on_rows silently fell to f32 for df32/extended-jnp
    tiers (ADVICE low)
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.hermite import Hermite4
from oc_nbody_tpu.io.snapshot import SnapshotWriter
from oc_nbody_tpu.models.plummer import plummer
from oc_nbody_tpu.ops import gravity
from oc_nbody_tpu.run import run
from oc_nbody_tpu.scene import build_units


def _tiny_cfg(out_dir, t_end=0.25):
    cfg = SimConfig()
    cfg.ic.n = 64
    cfg.ic.seed = 3
    cfg.integrator.kind = "kdk"
    cfg.integrator.dt = 1.0 / 64
    cfg.integrator.eps = 1.0 / 32
    cfg.output.out_dir = str(out_dir)
    cfg.output.t_end = t_end
    cfg.output.diag_every = 0.25
    cfg.output.snap_every = 0.25
    cfg.output.stdout = False
    cfg.backend = "jnp"
    return cfg


def test_run_does_not_mutate_config(tmp_path):
    """W4: the Myr->code-unit conversion must live on a local copy."""
    cfg = _tiny_cfg(tmp_path)
    us = build_units(cfg)
    cfg.output.t_end_myr = 0.25 * us.time_myr
    cfg.output.diag_every_myr = 0.25 * us.time_myr
    cfg.output.snap_every_myr = 0.25 * us.time_myr
    cfg.output.t_end = 123.0       # sentinel: must never be overwritten
    cfg.output.diag_every = 456.0
    res1 = run(cfg)
    assert cfg.output.t_end == 123.0
    assert cfg.output.diag_every == 456.0
    # a second run of the SAME config object behaves identically
    res2 = run(cfg)
    assert abs(float(res2.state.time) - float(res1.state.time)) < 1e-12


def test_rdma_requires_pallas_backend():
    """W6: construction-time error instead of a late lowering one — the
    removed rdma mode is refused on every backend."""
    from oc_nbody_tpu.parallel import make_mesh, make_sharded_force
    with pytest.raises(ValueError, match="rdma"):
        make_sharded_force(eps=0.01, mesh=make_mesh(8), mode="rdma",
                           backend="jnp")
    with pytest.raises(ValueError, match="mode"):
        make_sharded_force(eps=0.01, mesh=make_mesh(8), mode="bogus")


def test_hermite_restore_clamps_dt(key):
    """W7: resuming under a tighter dt_max must re-shape the stored dt."""
    state = plummer(64, key)
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    loose = Hermite4(force=force, dt_max=1.0 / 4)
    carry = loose.init(state)
    aux = {k: np.asarray(v) for k, v in loose.checkpoint_aux(carry).items()}
    aux["dt"] = np.float64(1.0 / 4)          # stored at the old, loose cap
    tight = Hermite4(force=force, dt_max=1.0 / 64)
    restored = tight.restore(state, aux)
    assert float(restored.dt) <= 1.0 / 64 + 1e-300
    # quantized steppers also re-snap to the grid
    tq = Hermite4(force=force, dt_max=1.0 / 64, quantize=True)
    rq = tq.restore(state, aux)
    k2 = math.log2((1.0 / 64) / float(rq.dt))
    assert k2 == round(k2)


def test_hermite_quantize_exact_power_of_two(key):
    """Missing #4: quantized dt must be EXACTLY dt_max / 2^k — formed by an
    int64 shift, not float 2.0**(-k) (which is not bit-exact under
    emulated f64; see integrators/block.py 'Integer time grid')."""
    state = plummer(32, key)
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    dt_max = 1.0 / 4
    st = Hermite4(force=force, dt_max=dt_max, quantize=True)
    for raw in (0.3, 0.13, 0.031, 1.7e-3, 7.3e-5, 2.2e-9):
        dt = float(st._shape_dt(jnp.asarray(raw, jnp.float64)))
        k = round(math.log2(dt_max / dt))
        assert dt == dt_max / (1 << k), (raw, dt)     # bit-exact grid value
        assert dt <= raw + 1e-300                      # largest value <= raw
        assert dt * 2 > raw or dt == dt_max            # ...and the largest
        # idempotent: a grid value re-quantizes to itself (bitwise resume)
        assert float(st._shape_dt(jnp.asarray(dt, jnp.float64))) == dt


def test_resume_without_snapshot_refuses_to_wipe(tmp_path):
    """ADVICE low: --resume into a dir with outputs but no snapshot must
    not destroy them by falling through to the fresh-run reset."""
    cfg = _tiny_cfg(tmp_path)
    w = SnapshotWriter(str(tmp_path), async_io=False)
    w.append_diagnostics({"time": 0.0, "E_tot": -0.25})
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        run(cfg, resume=True)
    # the diagnostics survived the refused resume
    d = SnapshotWriter(str(tmp_path), async_io=False).read_diagnostics()
    assert len(d["time"]) == 1
    # resume into a genuinely EMPTY dir still starts fresh (nothing to lose)
    cfg2 = _tiny_cfg(tmp_path / "fresh")
    res = run(cfg2, resume=True)
    assert float(res.state.time) >= 0.25 - 1e-9


def test_accel_jerk_on_rows_tier_routing(key):
    """ADVICE low: df32 (any backend) and extended-on-jnp active-row
    evaluations must NOT silently fall to the f32 rows path; they now run
    in f64, so their error vs the f64 oracle is orders below f32's."""
    kp, km, kv = jax.random.split(key, 3)
    n = 256
    pos = jax.random.normal(kp, (n, 3), jnp.float64)
    vel = 0.1 * jax.random.normal(kv, (n, 3), jnp.float64)
    mass = jax.random.uniform(km, (n,), jnp.float64, 0.5, 1.5) / n
    rows, vrows = pos[:32], vel[:32]
    eps = 0.05
    ref_a, ref_j = gravity.accel_jerk_rows(rows, vrows, pos, vel, mass, eps,
                                           1.0, 256)

    def err(precision):
        f = make_force_model(eps=eps, backend="jnp", precision=precision)
        a, j = f.accel_jerk_on_rows(rows, vrows, pos, vel, mass)
        return float(jnp.max(jnp.abs(a - ref_a)) + jnp.max(jnp.abs(j - ref_j)))

    e_f32 = err("f32")
    assert err("df32") < e_f32 / 100
    assert err("extended") < e_f32 / 100
