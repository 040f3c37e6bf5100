"""Block-timestep correctness (SURVEY.md §4.2: forced-uniform equivalence,
§7 hard part #2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu import diagnostics
from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.block import BlockHermite
from oc_nbody_tpu.integrators.hermite import Hermite4
from oc_nbody_tpu.models.plummer import plummer


def test_uniform_equivalence():
    """n_levels=1 forces every particle onto dt_max -> must match the
    shared fixed-dt Hermite trajectory."""
    state = plummer(64, jax.random.PRNGKey(17))
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    h = 1.0 / 64

    block = BlockHermite(force=force, dt_max=h, n_levels=1, n_buckets=0)
    bc = block.init(state)
    bc = jax.jit(block.advance, static_argnums=1)(bc, 16)

    herm = Hermite4(force=force, eta=1e12, dt_max=h)
    hc = herm.init(state)
    import dataclasses
    hc = dataclasses.replace(hc, dt=jnp.asarray(h, jnp.float64))
    hc = jax.jit(herm.advance, static_argnums=1)(hc, 16)

    np.testing.assert_allclose(np.asarray(bc.state.pos), np.asarray(hc.state.pos),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(bc.state.vel), np.asarray(hc.state.vel),
                               rtol=0, atol=1e-13)


def test_bucketed_matches_masked():
    """Compacted (bucketed-gather) evaluation == masked full evaluation."""
    state = plummer(96, jax.random.PRNGKey(19))
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    kw = dict(force=force, dt_max=1.0 / 32, n_levels=4, eta=0.01)

    b_mask = BlockHermite(n_buckets=0, **kw)
    b_comp = BlockHermite(n_buckets=4, **kw)
    c_mask = jax.jit(b_mask.advance, static_argnums=1)(b_mask.init(state), 40)
    c_comp = jax.jit(b_comp.advance, static_argnums=1)(b_comp.init(state), 40)

    np.testing.assert_allclose(np.asarray(c_comp.state.pos),
                               np.asarray(c_mask.state.pos), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(c_comp.dt_i), np.asarray(c_mask.dt_i))


def test_block_synchronises_and_conserves():
    """advance_to a dt_max multiple: all particles land there exactly, and
    energy is conserved to Hermite-level accuracy."""
    state = plummer(128, jax.random.PRNGKey(23))
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    block = BlockHermite(force=force, dt_max=1.0 / 16, n_levels=6, eta=0.01)
    carry = block.init(state)
    e0 = float(diagnostics.energies(state, force)["E_tot"])

    carry = jax.jit(block.advance_to)(carry, 0.5)
    t_phys = np.asarray(carry.t_i) * block.dt_min
    np.testing.assert_array_equal(t_phys, 0.5)
    assert float(carry.state.time) == 0.5

    e1 = float(diagnostics.energies(carry.state, force)["E_tot"])
    assert abs(e1 - e0) / abs(e0) < 1e-5

    # rung hierarchy actually in use: strictly less work than all-active
    n_steps = int(carry.n_steps)
    n_active = int(carry.n_active_sum)
    assert n_active < n_steps * state.n
    assert len(np.unique(np.asarray(carry.dt_i))) > 1


def test_block_resume_bitwise(tmp_path):
    from oc_nbody_tpu.io.snapshot import read_snapshot, write_snapshot

    state = plummer(64, jax.random.PRNGKey(29))
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    block = BlockHermite(force=force, dt_max=1.0 / 32, n_levels=4)
    advance = jax.jit(block.advance, static_argnums=1)
    mid = advance(block.init(state), 20)
    ref = advance(mid, 20)

    path = str(tmp_path / "blk.npz")
    write_snapshot(path, mid.state, aux=block.checkpoint_aux(mid),
                   integrator_kind="block")
    snap = read_snapshot(path)
    resumed = advance(block.restore(snap.state, snap.aux), 20)
    np.testing.assert_array_equal(np.asarray(resumed.state.pos),
                                  np.asarray(ref.state.pos))
    np.testing.assert_array_equal(np.asarray(resumed.t_i), np.asarray(ref.t_i))


def test_block_pec2_runs_and_conserves():
    """PEC² on active rows (round-3 W2 instrumentation): synchronises,
    conserves to the same order as single-pass PEC, and actually changes
    the trajectory (i.e. the second corrector pass is live). At these
    settings both drifts sit at the 1e-8 noise floor, so no ordering
    between them is asserted — the pec2 accuracy claim is measured on the
    c4 pericentre experiment (RESULTS.md), not here."""
    state = plummer(128, jax.random.PRNGKey(29))
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    kw = dict(force=force, dt_max=1.0 / 16, n_levels=6, eta=0.02)
    e0 = float(diagnostics.energies(state, force)["E_tot"])

    ends = {}
    for pec2 in (False, True):
        b = BlockHermite(pec2=pec2, **kw)
        c = jax.jit(b.advance_to)(b.init(state), 0.5)
        assert float(c.state.time) == 0.5
        e1 = float(diagnostics.energies(c.state, force)["E_tot"])
        assert abs(e1 - e0) / abs(e0) < 1e-6
        ends[pec2] = np.asarray(c.state.pos)
    assert np.max(np.abs(ends[True] - ends[False])) > 0


def test_block_resume_on_finer_grid(tmp_path):
    """Round-5: a checkpoint may be resumed on a FINER block grid (old
    dt_min an exact power-of-two multiple of the new) — the integer
    times rescale exactly and the run continues healthy. This is the
    mid-run stepping-refinement path the flagship dt study uses."""
    from oc_nbody_tpu.diagnostics import energies
    from oc_nbody_tpu.io.snapshot import read_snapshot, write_snapshot

    state = plummer(64, jax.random.PRNGKey(31))
    force = make_force_model(eps=1.0 / 32, backend="jnp")
    coarse = BlockHermite(force=force, dt_max=1.0 / 32, n_levels=4)
    mid = jax.jit(coarse.advance_to)(coarse.init(state), 1.0 / 32)

    path = str(tmp_path / "blk.npz")
    write_snapshot(path, mid.state, aux=coarse.checkpoint_aux(mid),
                   integrator_kind="block")
    snap = read_snapshot(path)

    fine = BlockHermite(force=force, dt_max=1.0 / 64, n_levels=5)
    c = fine.restore(snap.state, snap.aux)
    # physical per-particle times and rung lengths preserved (up to the
    # new dt_max clamp)
    np.testing.assert_allclose(
        np.asarray(c.t_i, dtype=np.float64) * fine.dt_min,
        np.asarray(mid.t_i, dtype=np.float64) * coarse.dt_min, rtol=0)
    assert np.asarray(c.dt_i).max() <= fine._dt_int_max
    # continues and conserves on the refined grid
    e0 = energies(mid.state, force)["E_tot"]
    c = jax.jit(fine.advance_to)(c, 3.0 / 32)
    np.testing.assert_allclose(float(c.state.time), 3.0 / 32, rtol=1e-12)
    e1 = energies(c.state, force)["E_tot"]
    assert abs((float(e1) - float(e0)) / float(e0)) < 1e-5
