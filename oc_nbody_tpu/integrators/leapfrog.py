"""KDK leapfrog (kick–drift–kick), fixed timestep — plus the 4th-order
Yoshida composition built from it.

Capability parity: SURVEY.md §2.9a / §3.2 — the reference's leapfrog
stepper (BASELINE.json:5, :7). Symplectic and time-reversible; one force
evaluation per step (the closing kick's acceleration is cached and reused
as the next step's opening kick). Yoshida4 (beyond the reference's
inventory) composes three KDK substeps with Yoshida (1990) coefficients
for dt⁴ energy scaling at 3 force evals/step — worthwhile whenever the
error budget would otherwise force dt below ~1/3 of the KDK value.

The whole step is a pure function carry -> carry; `advance` wraps k steps
in a lax.fori_loop so the hot loop is a single XLA computation
(SURVEY.md §3.1 "superstep").

Precision: positions/velocities update in the state dtype (f64 by default);
the force kernel internally computes in f32 on centred offsets.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from oc_nbody_tpu.forces import ForceModel
from oc_nbody_tpu.state import ParticleState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KDKCarry:
    state: ParticleState
    acc: jax.Array          # cached total acceleration at state.time
    n_steps: jax.Array      # int64 step counter

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LeapfrogKDK:
    """Fixed-dt KDK leapfrog stepper."""

    force: ForceModel
    dt: float

    def init(self, state: ParticleState) -> KDKCarry:
        acc = self.force.at_time(state.time).accel(
            state.pos, state.mass, vel=state.vel).astype(state.pos.dtype)
        return KDKCarry(state=state, acc=acc,
                        n_steps=jnp.asarray(0, jnp.int64))

    def step(self, carry: KDKCarry) -> KDKCarry:
        s, acc = carry.state, carry.acc
        dt = jnp.asarray(self.dt, s.pos.dtype)
        v_half = s.vel + (0.5 * dt) * acc
        pos_new = s.pos + dt * v_half
        # the closing force eval is at the step's END time (time-dependent
        # externals bind it; static externals: at_time is a no-op). The
        # velocity rides along for velocity-dependent terms (dynamical
        # friction): v_half is the midpoint value — the standard kick-point
        # evaluation for a weak dissipative force.
        acc_new = self.force.at_time(s.time + dt).accel(
            pos_new, s.mass, vel=v_half).astype(s.pos.dtype)
        vel_new = v_half + (0.5 * dt) * acc_new
        state_new = s.replace(pos=pos_new, vel=vel_new, time=s.time + dt)
        return KDKCarry(state=state_new, acc=acc_new, n_steps=carry.n_steps + 1)

    def advance(self, carry: KDKCarry, n: int) -> KDKCarry:
        """n steps as one on-device loop (the superstep)."""
        return jax.lax.fori_loop(0, n, lambda _, c: self.step(c), carry)

    def advance_to(self, carry: KDKCarry, t_end) -> KDKCarry:
        """Step until state.time >= t_end (whole steps; fixed dt)."""
        def cond(c):
            return c.state.time < t_end - 1e-12 * jnp.abs(t_end)

        return jax.lax.while_loop(cond, lambda c: self.step(c), carry)

    def advance_to_bounded(self, carry: KDKCarry, t_end,
                           max_steps: int) -> KDKCarry:
        """advance_to with a per-dispatch step cap (driver loops on host)."""
        start = carry.n_steps

        def cond(c):
            return (c.state.time < t_end - 1e-12 * jnp.abs(t_end)) & (
                c.n_steps - start < max_steps)

        return jax.lax.while_loop(cond, lambda c: self.step(c), carry)

    def reached(self, carry: KDKCarry, t_end) -> bool:
        return float(carry.state.time) >= float(t_end) - 1e-12 * abs(float(t_end))

    # aux arrays that must survive a checkpoint for bitwise resume
    def checkpoint_aux(self, carry: KDKCarry) -> dict:
        return {"acc": carry.acc, "n_steps": carry.n_steps}

    def restore(self, state: ParticleState, aux: dict) -> KDKCarry:
        if "acc" in aux:
            return KDKCarry(state=state, acc=jnp.asarray(aux["acc"]),
                            n_steps=jnp.asarray(aux.get("n_steps", 0), jnp.int64))
        return self.init(state)


# Yoshida (1990) 4th-order composition coefficients: three leapfrog
# substeps of lengths (w1, w0, w1)·dt with w1+w0+w1 = 1; the negative
# middle substep cancels the dt³ error term of the composition.
_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W0 = 1.0 - 2.0 * _W1          # = -2^{1/3}/(2-2^{1/3}) < 0


@dataclasses.dataclass(frozen=True)
class Yoshida4(LeapfrogKDK):
    """4th-order symplectic integrator (Yoshida composition of KDK).

    Same carry/aux/snapshot contract as LeapfrogKDK (the cached closing
    acceleration doubles as the next step's opening kick across the
    substep boundary, so the cost is exactly 3 force evals per step).
    Energy error scales as dt⁴ (tests/physics/test_yoshida.py) — at equal
    error budgets this beats KDK whenever KDK would need dt smaller than
    ~1/3 the Yoshida step. Substep evaluation times are computed as
    state.time + c_i·dt (absolute, not accumulated), so time-dependent
    externals bind exact times and state.time advances by exactly dt.
    """

    def step(self, carry: KDKCarry) -> KDKCarry:
        s, acc = carry.state, carry.acc
        dtype = s.pos.dtype
        dt = jnp.asarray(self.dt, dtype)
        pos, vel = s.pos, s.vel
        # cumulative end-time fractions of the three substeps
        cum = (_W1, _W1 + _W0, 1.0)
        for w, c in zip((_W1, _W0, _W1), cum):
            h = jnp.asarray(w, dtype) * dt
            v_half = vel + (0.5 * h) * acc
            pos = pos + h * v_half
            acc = self.force.at_time(s.time + c * dt).accel(
                pos, s.mass, vel=v_half).astype(dtype)
            vel = v_half + (0.5 * h) * acc
        state_new = s.replace(pos=pos, vel=vel, time=s.time + dt)
        return KDKCarry(state=state_new, acc=acc,
                        n_steps=carry.n_steps + 1)


# the O(N) halves of a KDK step as one tiny jitted program each
# (module-level so every MacroKDK step hits the same jit cache entry)
@jax.jit
def _kdk_kick_drift(state, acc, dt):
    dt = jnp.asarray(dt, state.pos.dtype)
    v_half = state.vel + (0.5 * dt) * acc
    return state.replace(pos=state.pos + dt * v_half, vel=v_half)


@jax.jit
def _kdk_close(state, acc_new, dt):
    dt = jnp.asarray(dt, state.pos.dtype)
    return state.replace(vel=state.vel + (0.5 * dt) * acc_new,
                         time=state.time + dt)


@dataclasses.dataclass(frozen=True)
class MacroKDK(LeapfrogKDK):
    """Host-stepped KDK for N past the single-XLA-program window.

    One in-jit force eval at N = 4M-8M is a long XLA program — past
    runtime watchdogs / pre-emption windows — so the superstep design
    inverts: each force evaluation runs as ``n_batches`` separate
    same-shape dispatches (ForceModel.accel_batched → one-sided row
    chunks against all sources) and
    the kick/drift updates are small O(N) jitted programs between them.
    Same trajectory as LeapfrogKDK up to f32 pair-summation order.
    Subclasses LeapfrogKDK so reached/checkpoint_aux/restore — the
    snapshot-interchange contract — are literally the same code (the
    MacroHermite pattern); the in-jit loop methods are overridden with
    host loops (accel_batched is the dispatch splitting itself and must
    not be traced). ``host_stepping = True`` tells run.py not to wrap
    ``advance_to_bounded`` in jit and to precompute the diagnostics
    potential batched. Enable with ``integrator.macro_batches > 0``
    (see configs/c7_2m_chunked.toml header for the in-jit 2M point this
    takes over from)."""

    n_batches: int = 8
    host_stepping: bool = True

    def _accel(self, pos, mass, t, vel=None):
        # ``vel`` is the kick-point velocity (same contract as the in-jit
        # steppers' force.accel calls) — required when the force carries
        # dynamical friction, unused otherwise
        return self.force.at_time(t).accel_batched(
            pos, mass, n_batches=self.n_batches, vel=vel).astype(pos.dtype)

    def init(self, state: ParticleState) -> KDKCarry:
        acc = self._accel(state.pos, state.mass, state.time,
                          vel=state.vel)
        return KDKCarry(state=state, acc=acc,
                        n_steps=jnp.asarray(0, jnp.int64))

    # ---- host-driven loop methods (the in-jit ones do not apply) -------
    def step(self, carry: KDKCarry) -> KDKCarry:
        s_half = _kdk_kick_drift(carry.state, carry.acc, self.dt)
        # s_half.time is still the step-START time (_kdk_close advances
        # it); the closing eval happens at the step's END time
        acc_new = self._accel(s_half.pos, s_half.mass,
                              s_half.time + self.dt, vel=s_half.vel)
        s_new = _kdk_close(s_half, acc_new, self.dt)
        return KDKCarry(state=s_new, acc=acc_new, n_steps=carry.n_steps + 1)

    def advance(self, carry: KDKCarry, n: int) -> KDKCarry:
        for _ in range(n):
            carry = self.step(carry)
        return carry

    def advance_to(self, carry: KDKCarry, t_end) -> KDKCarry:
        return self.advance_to_bounded(carry, t_end, 10 ** 9)

    def advance_to_bounded(self, carry: KDKCarry, t_end,
                           max_steps: int) -> KDKCarry:
        done = 0
        while (not self.reached(carry, t_end)) and done < max_steps:
            carry = self.step(carry)
            done += 1
        return carry


@jax.jit
def _sub_close(state, acc_new, h):
    """Close a Yoshida substep WITHOUT advancing time (the macro step sets
    the absolute end time once, like the in-jit Yoshida4)."""
    h = jnp.asarray(h, state.pos.dtype)
    return state.replace(vel=state.vel + (0.5 * h) * acc_new)


@dataclasses.dataclass(frozen=True)
class MacroYoshida4(MacroKDK):
    """Host-stepped Yoshida4 for N past the single-XLA-program window —
    three batched force evals per step through the MacroKDK dispatch
    machinery; same carry/aux contract, same trajectory as Yoshida4 up
    to f32 pair-summation order."""

    def step(self, carry: KDKCarry) -> KDKCarry:
        s = carry.state
        acc = carry.acc
        cum = (_W1, _W1 + _W0, 1.0)
        state = s
        for w, c in zip((_W1, _W0, _W1), cum):
            h = w * self.dt
            state = _kdk_kick_drift(state, acc, h)
            acc = self._accel(state.pos, state.mass,
                              s.time + c * self.dt, vel=state.vel)
            state = _sub_close(state, acc, h)
        state = state.replace(time=s.time + self.dt)
        return KDKCarry(state=state, acc=acc, n_steps=carry.n_steps + 1)
