"""Full driver (config -> scene -> run) on the 8-device emulated mesh:
the config-5 composition END-TO-END, not just the ShardedForce unit
(SURVEY.md §4.3 — the same test re-runs unchanged on real devices).
"""
import os

import jax
import numpy as np
import pytest

from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.run import run

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def _mesh_cfg(tmp_path, mode, backend="jnp", n=96):
    cfg = SimConfig()
    cfg.ic.n = n
    cfg.ic.seed = 5
    cfg.integrator.dt = 1.0 / 128
    cfg.integrator.eps = 1.0 / 16
    cfg.output.out_dir = str(tmp_path / f"run_{mode}")
    cfg.output.t_end = 0.25
    cfg.output.diag_every = 0.125
    cfg.output.snap_every = 0.25
    cfg.output.stdout = False
    cfg.backend = backend
    cfg.mesh.n_devices = 8
    cfg.mesh.mode = mode
    return cfg


@pytest.mark.parametrize("mode", ["allgather", "ring", "halfring"])
def test_driver_on_mesh_matches_single_device(tmp_path, mode):
    res = run(_mesh_cfg(tmp_path, mode))
    cfg1 = _mesh_cfg(tmp_path, mode)
    cfg1.mesh.n_devices = 1
    cfg1.output.out_dir = str(tmp_path / "run_single")
    res1 = run(cfg1)
    np.testing.assert_allclose(np.asarray(res.state.pos),
                               np.asarray(res1.state.pos), atol=1e-9)
    assert abs(res.diagnostics["dE_over_E"][-1]) < 1e-5
    assert os.path.exists(os.path.join(
        _mesh_cfg(tmp_path, mode).output.out_dir, "diagnostics.npz"))


def test_driver_on_mesh_with_stellar_evolution(tmp_path):
    """[sev] through the sharded driver: the death-table where-update and
    the carry rebuild must compose with sharded state arrays, and the
    mesh run must apply the same (deterministic) death schedule as the
    single-device run."""
    def cfg_at(d, name):
        cfg = _mesh_cfg(tmp_path, "allgather", n=96)
        cfg.mesh.n_devices = d
        cfg.output.out_dir = str(tmp_path / name)
        # top-heavy IMF + physical-mass units so several stars die inside
        # a short run (time unit ≈ 1.2 Myr; lifetimes 3 Myr upward)
        cfg.units.mass_msun = 1235.0
        cfg.units.length_pc = 2.0
        cfg.ic.imf = "salpeter"
        cfg.ic.m_min_msun = 5.0
        cfg.ic.m_max_msun = 100.0
        cfg.sev.kind = "simple"
        cfg.sev.epoch0_myr = 3.0
        cfg.sev.kick_sigma_ns_kms = 20.0
        cfg.output.t_end = 2.0
        cfg.output.diag_every = 0.5
        cfg.output.snap_every = 1.0
        return cfg

    res8 = run(cfg_at(8, "sev_mesh"))
    res1 = run(cfg_at(1, "sev_single"))
    assert res8.diagnostics["N_rem"][-1] > 0, "no deaths — test is vacuous"
    np.testing.assert_array_equal(np.asarray(res8.diagnostics["N_rem"]),
                                  np.asarray(res1.diagnostics["N_rem"]))
    np.testing.assert_allclose(np.asarray(res8.state.mass),
                               np.asarray(res1.state.mass), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(res8.state.pos),
                               np.asarray(res1.state.pos), atol=1e-7)
    np.testing.assert_allclose(res8.diagnostics["E_sev_cum"][-1],
                               res1.diagnostics["E_sev_cum"][-1], rtol=1e-6)


def test_driver_on_mesh_with_time_dependent_external(tmp_path):
    """A time-dependent external ([potential.gas] expelled mid-run) through
    the sharded driver: ShardedForce.at_time must bind the evaluation time
    on every shard's local rows, matching the single-device run."""
    from oc_nbody_tpu.utils.units import UnitSystem

    tm = UnitSystem.henon(mass_msun=1.0, length_pc=1.0).time_myr

    def cfg_at(d, name):
        cfg = _mesh_cfg(tmp_path, "allgather", n=96)
        cfg.mesh.n_devices = d
        cfg.output.out_dir = str(tmp_path / name)
        cfg.units.mass_msun = 1.0
        cfg.units.length_pc = 1.0
        cfg.ic.vel_scale = float(np.sqrt(2.0))
        cfg.potential.gas.kind = "plummer"
        cfg.potential.gas.mass_msun = 1.0
        cfg.potential.gas.scale_pc = 1.0
        cfg.potential.gas.t_expel_myr = 0.05 * tm
        cfg.potential.gas.expel_myr = 0.1 * tm
        cfg.output.t_end = 0.25
        return cfg

    res8 = run(cfg_at(8, "gas_mesh"))
    res1 = run(cfg_at(1, "gas_single"))
    np.testing.assert_allclose(np.asarray(res8.state.pos),
                               np.asarray(res1.state.pos), atol=1e-9)
    # the expulsion really happened inside the run window
    assert res8.diagnostics["E_ext"][0] < -0.1
    assert abs(res8.diagnostics["E_ext"][-1]) < 1e-10


def test_driver_refuses_rdma_mode(tmp_path):
    """The removed mode='rdma' is refused when a config names it — at
    load, at a --set override, and by a SimConfig built in code — with a
    message that points to the ring mode."""
    from oc_nbody_tpu.config import apply_overrides, load_config

    path = tmp_path / "rdma.toml"
    path.write_text('[mesh]\nn_devices = 8\nmode = "rdma"\n')
    with pytest.raises(ValueError, match="rdma.*ring"):
        load_config(str(path))
    with pytest.raises(ValueError, match="rdma.*ring"):
        apply_overrides(SimConfig(), ["mesh.mode=rdma"])
    with pytest.raises(ValueError, match="rdma.*ring"):
        run(_mesh_cfg(tmp_path, "rdma", n=64))
