"""Every committed config file must load through the strict parser.

The configs/ directory is the acceptance suite (SURVEY.md §5 "the five
[B:7-11] configs ship as committed config files"); several of them can
only *run* on real hardware (macro/oversized N), so a typo'd key or an
inconsistent knob combination would otherwise surface only mid-run.
``SimConfig.from_dict`` rejects unknown sections/keys, so loading alone
is a real check; the semantic assertions pin the cross-field contracts
the driver relies on.
"""
import glob
import os

import pytest

from oc_nbody_tpu.config import SimConfig, load_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.toml")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)
                                               for p in CONFIGS])
def test_committed_config_loads_and_is_consistent(path):
    cfg = load_config(path)

    # identity round-trip through the dict form (what snapshots store)
    cfg2 = SimConfig.from_dict(cfg.to_dict())
    assert cfg2.to_dict() == cfg.to_dict()

    assert cfg.ic.kind in ("plummer", "king")
    assert cfg.ic.n > 0
    assert cfg.integrator.kind in ("kdk", "hermite", "block")
    assert cfg.integrator.eps >= 0.0
    assert cfg.backend in ("auto", "jnp", "pallas")
    assert cfg.output.out_dir

    # a run must have a stopping point in exactly one unit system
    has_code = cfg.output.t_end is not None and cfg.output.t_end > 0
    has_myr = getattr(cfg.output, "t_end_myr", None) is not None
    assert has_code or has_myr, f"{path}: no t_end / t_end_myr"

    if cfg.integrator.kind == "kdk":
        assert cfg.integrator.dt > 0
    if cfg.integrator.macro_batches:
        # the batched path serves the f32/extended tiers on every backend
        # (forces.py _require_batched); a committed macro config must not
        # route to a tier that raises at the first eval
        assert cfg.integrator.precision in ("f32", "extended")
        assert cfg.integrator.kind in ("kdk", "hermite")
    if cfg.integrator.precision != "f32":
        assert cfg.integrator.precision in ("extended", "df32")
    if cfg.mesh.n_devices not in (None, 0, 1):
        # sharded tiers: df32 is rejected at build_scene on a mesh
        assert cfg.integrator.precision in ("f32", "extended")


def test_all_acceptance_configs_present():
    """The judged capability ladder stays committed: c1-c8 plus the
    north-star config (BASELINE.json:6-12 / SURVEY §2.13)."""
    names = {os.path.basename(p) for p in CONFIGS}
    for required in [
        "c1_plummer_1k.toml", "c2_king_8k_circular.toml",
        "c3_hermite_16k_kroupa.toml", "c4_block_32k_eccentric.toml",
        "c5_131k_sharded.toml", "c6_1m_streamed.toml",
        "c7_2m_chunked.toml", "c8_8m_macro.toml",
        "north_star_65k_orbit.toml",
    ]:
        assert required in names, f"missing acceptance config {required}"
