"""Snapshot round-trip and bitwise resume (SURVEY.md §4.4)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.hermite import Hermite4
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu.io.snapshot import (SnapshotWriter, latest_snapshot,
                                      read_snapshot, write_snapshot)
from oc_nbody_tpu.models.plummer import plummer
from oc_nbody_tpu.utils.units import UnitSystem


def _state():
    return plummer(64, jax.random.PRNGKey(21))


def test_round_trip_bit_exact(tmp_path):
    state = _state()
    us = UnitSystem.henon(1000.0, 1.0)
    path = str(tmp_path / "snap.npz")
    write_snapshot(path, state, aux={"acc": np.zeros((64, 3))},
                   integrator_kind="kdk", units=us, attrs={"step": 7})
    snap = read_snapshot(path)
    np.testing.assert_array_equal(np.asarray(snap.state.pos), np.asarray(state.pos))
    np.testing.assert_array_equal(np.asarray(snap.state.vel), np.asarray(state.vel))
    np.testing.assert_array_equal(np.asarray(snap.state.mass), np.asarray(state.mass))
    np.testing.assert_array_equal(np.asarray(snap.state.ids), np.asarray(state.ids))
    assert float(snap.state.time) == float(state.time)
    assert snap.integrator_kind == "kdk"
    assert snap.units == us
    assert snap.attrs["step"] == 7


def test_kdk_bitwise_resume(tmp_path):
    state = _state()
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    stepper = LeapfrogKDK(force=force, dt=1.0 / 256)
    advance = jax.jit(stepper.advance, static_argnums=1)

    carry = stepper.init(state)
    carry_mid = advance(carry, 100)
    ref = advance(carry_mid, 100)

    path = str(tmp_path / "mid.npz")
    write_snapshot(path, carry_mid.state, aux=stepper.checkpoint_aux(carry_mid),
                   integrator_kind="kdk")
    snap = read_snapshot(path)
    restored = stepper.restore(snap.state, snap.aux)
    resumed = advance(restored, 100)

    np.testing.assert_array_equal(np.asarray(resumed.state.pos),
                                  np.asarray(ref.state.pos))
    np.testing.assert_array_equal(np.asarray(resumed.state.vel),
                                  np.asarray(ref.state.vel))


def test_hermite_bitwise_resume(tmp_path):
    state = _state()
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    stepper = Hermite4(force=force, eta=0.02)
    advance = jax.jit(stepper.advance, static_argnums=1)

    carry_mid = advance(stepper.init(state), 50)
    ref = advance(carry_mid, 50)

    path = str(tmp_path / "mid.npz")
    write_snapshot(path, carry_mid.state, aux=stepper.checkpoint_aux(carry_mid),
                   integrator_kind="hermite")
    snap = read_snapshot(path)
    resumed = advance(stepper.restore(snap.state, snap.aux), 50)

    np.testing.assert_array_equal(np.asarray(resumed.state.pos),
                                  np.asarray(ref.state.pos))
    np.testing.assert_array_equal(np.asarray(resumed.state.vel),
                                  np.asarray(ref.state.vel))
    assert float(resumed.dt) == float(ref.dt)


def test_latest_snapshot_and_writer(tmp_path):
    writer = SnapshotWriter(str(tmp_path))
    state = _state()
    writer.write(0, state)
    writer.write(1, state)
    writer.flush()  # writes are async: settle before reading back
    assert latest_snapshot(str(tmp_path)).endswith("snapshot_00001.npz")
    writer.append_diagnostics({"E_tot": jnp.asarray(-0.25), "time": jnp.asarray(0.0)})
    writer.append_diagnostics({"E_tot": jnp.asarray(-0.26), "time": jnp.asarray(1.0)})
    d = writer.read_diagnostics()
    np.testing.assert_allclose(d["E_tot"], [-0.25, -0.26])


def test_determinism_same_key():
    """Same PRNG key -> bitwise-same IC and trajectory (SURVEY.md §5 race
    detection analog: determinism check)."""
    s1 = plummer(128, jax.random.PRNGKey(42))
    s2 = plummer(128, jax.random.PRNGKey(42))
    np.testing.assert_array_equal(np.asarray(s1.pos), np.asarray(s2.pos))
    force = make_force_model(eps=1.0 / 64, backend="jnp")
    stepper = LeapfrogKDK(force=force, dt=1.0 / 256)
    advance = jax.jit(stepper.advance, static_argnums=1)
    c1 = advance(stepper.init(s1), 64)
    c2 = advance(stepper.init(s2), 64)
    np.testing.assert_array_equal(np.asarray(c1.state.pos), np.asarray(c2.state.pos))
