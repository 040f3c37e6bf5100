"""4th-order Hermite predictor–corrector with shared adaptive timestep.

Capability parity: SURVEY.md §2.9b / §3.3 — the reference's Hermite-4
stepper with shared adaptive dt (BASELINE.json:5, :9). Scheme is the
classic Makino–Aarseth (1992) two-point Hermite method:

  predict : x_p = x + v dt + a dt²/2 + j dt³/6 ;  v_p = v + a dt + j dt²/2
  evaluate: (a1, j1) at (x_p, v_p)                [the O(N²) hot call]
  correct : v1 = v + dt/2 (a0+a1) + dt²/12 (j0−j1)
            x1 = x + dt/2 (v+v1)  + dt²/12 (a0−a1)
  dt      : Aarseth criterion from the interpolated 2nd/3rd derivatives,
            shared = min over particles, growth-limited, optionally
            quantized to dt_max/2^k.

Everything is branch-free under jit; `advance_to` runs a lax.while_loop on
device and lands exactly on t_end by clipping the final step
(SURVEY.md §7 hard part #5).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from oc_nbody_tpu.forces import ForceModel
from oc_nbody_tpu.state import ParticleState


def _norm(x):
    return jnp.sqrt(jnp.sum(x * x, axis=-1))


# ---- step math shared by the in-jit and host-stepped (macro) variants ----

def _correct(pos, vel, a0, j0, a1, j1, dt):
    """One Hermite corrector application (v first, then x from v1)."""
    dt2 = dt * dt
    v1 = vel + (dt / 2) * (a0 + a1) + (dt2 / 12) * (j0 - j1)
    x1 = pos + (dt / 2) * (vel + v1) + (dt2 / 12) * (a0 - a1)
    return x1, v1


def _interp_derivs(a0, j0, a1, j1, dt):
    """Interpolated (a², a³) at t0, a² shifted to t1."""
    dt2, dt3 = dt * dt, dt * dt * dt
    inv_dt2 = 1.0 / jnp.maximum(dt2, jnp.finfo(dt.dtype).tiny)
    inv_dt3 = 1.0 / jnp.maximum(dt3, jnp.finfo(dt.dtype).tiny)
    a2_0 = (-6.0 * (a0 - a1) - dt * (4.0 * j0 + 2.0 * j1)) * inv_dt2
    a3 = (12.0 * (a0 - a1) + 6.0 * dt * (j0 + j1)) * inv_dt3
    a2_1 = a2_0 + dt * a3
    return a2_1, a3


def _aarseth_shared_dt(a1, j1, a2_1, a3, eta):
    na, nj = _norm(a1), _norm(j1)
    n2, n3 = _norm(a2_1), _norm(a3)
    tiny = jnp.finfo(na.dtype).tiny
    num = na * n2 + nj * nj
    den = nj * n3 + n2 * n2
    dt2 = eta * num / jnp.maximum(den, tiny)
    dt_i = jnp.sqrt(dt2)
    return jnp.min(jnp.where(den > 0, dt_i, jnp.inf))


def _shape_dt_fn(dt, dt_min, dt_max, quantize: bool):
    dt = jnp.clip(dt, dt_min, dt_max)
    if quantize:
        # largest dt_max/2^k <= dt, k >= 0. The quantized value is built
        # as dt_max * (1 / 2^k) with the power of two formed by an exact
        # int64 shift — `2.0 ** (-k)` through an emulated f64 pow is NOT
        # bit-exact (the failure mode the block integrator's
        # int grid eliminated, integrators/block.py "Integer time grid";
        # VERDICT round-2 Missing #4). log2 is only a selector; the
        # result is exact for k <= 62.
        k = jnp.ceil(jnp.log2(dt_max / jnp.maximum(dt, 1e-300)))
        k = jnp.clip(k, 0.0, 62.0).astype(jnp.int64)
        pow2 = jnp.left_shift(jnp.int64(1), k).astype(jnp.float64)
        dt = dt_max / pow2
        # quantization rounds DOWN and can land below dt_min — the safety
        # clamp wins over the grid (the value is then off-grid, which only
        # costs one off-phase step; stepping below dt_min never happens)
        dt = jnp.maximum(dt, dt_min)
    return dt


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HermiteCarry:
    state: ParticleState
    acc: jax.Array       # (N, 3) at state.time
    jerk: jax.Array      # (N, 3) at state.time
    dt: jax.Array        # scalar shared timestep (next step size)
    n_steps: jax.Array   # int64

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Hermite4:
    """Shared-adaptive-dt Hermite-4 stepper."""

    force: ForceModel
    eta: float = 0.02          # Aarseth accuracy parameter
    eta_init: float = 0.01     # startup criterion scale
    dt_max: float = jnp.inf    # upper clamp
    dt_min: float = 0.0        # lower clamp (safety)
    quantize: bool = False     # snap dt to dt_max / 2^k
    # PEC²: a second (evaluate, correct) pass at the corrected state —
    # doubles the force work per step but shrinks the error constant
    # (the corrector is iterated once toward its fixed point); same 4th
    # order. Standard option in Makino–Aarseth Hermite codes.
    pec2: bool = False
    # Time-symmetrized step selection (Hut, Makino & McMillan 1995): the
    # executed dt is the average of the criterion at the step's START
    # (the carried dt) and at its trial END — one fixed-point iteration
    # toward dt = h((t) + (t+dt))/2. A time-asymmetric dt(t) makes the
    # otherwise-symmetric Hermite scheme secularly drift on periodic
    # (binary-dominated) orbits; symmetrizing kills the secular term at
    # the cost of ONE extra force evaluation per step (the trial pass) —
    # the post-collapse mitigation knob (VERDICT round-3 Missing #4).
    # Composes with pec2 (then 3 evals/step).
    symmetrized: bool = False
    # Pair-aware dt cap (round-5, shared-dt form of the block pair_dt):
    # the shared dt is additionally capped at eta_pair × the GLOBAL
    # minimum softened two-body encounter timescale. The Aarseth
    # criterion is force-derived and the softened force vanishes through
    # the core, so an eccentric pair diving inside eps gets the shared
    # dt *grown* right at pericentre; the fly-by term (~eps/v) stays
    # finite there. Costs one O(N²) min-sweep per step (~1/4 the jerk
    # eval's flops).
    pair_dt: bool = False
    eta_pair: float = 0.02
    # near-field window in eps units (0 = none) — see BlockHermite
    pair_r_max: float = 4.0

    def __post_init__(self):
        import math
        if self.quantize and not math.isfinite(float(self.dt_max)):
            # dt_max/2^k with dt_max=inf is inf for every k — the first
            # predictor step would produce inf positions and die as NaN
            # energies instead of a clear message
            raise ValueError(
                "quantize=True requires a finite dt_max (the quantization "
                "grid is dt_max / 2^k)")

    def init(self, state: ParticleState) -> HermiteCarry:
        acc, jerk = self.force.at_time(state.time).accel_jerk(
            state.pos, state.vel, state.mass)
        acc = acc.astype(state.pos.dtype)
        jerk = jerk.astype(state.pos.dtype)
        a = _norm(acc)
        j = _norm(jerk)
        dt0 = self.eta_init * jnp.min(
            jnp.where(j > 0, a / jnp.maximum(j, jnp.finfo(a.dtype).tiny), jnp.inf)
        )
        dt0 = jnp.minimum(dt0, self.dt_max)
        dt0 = jnp.where(jnp.isfinite(dt0), dt0, jnp.asarray(self.dt_max))
        if self.pair_dt:
            dt0 = jnp.minimum(dt0, self.eta_pair * self._pair_tau_min(
                state.pos, state.vel, state.mass))
        return HermiteCarry(state=state, acc=acc, jerk=jerk,
                            dt=self._shape_dt(dt0),
                            n_steps=jnp.asarray(0, jnp.int64))

    # ---- helpers ------------------------------------------------------
    def _shape_dt(self, dt):
        return _shape_dt_fn(dt, self.dt_min, self.dt_max, self.quantize)

    def _pair_tau_min(self, pos, vel, mass):
        """Global minimum softened encounter timescale (f32 sweep — the
        timescale only picks dt; centred like the force kernels)."""
        from oc_nbody_tpu.ops import gravity
        center = jnp.mean(pos, axis=0)
        vcenter = jnp.mean(vel, axis=0)
        pos_c = (pos - center).astype(jnp.float32)
        vel_c = (vel - vcenter).astype(jnp.float32)
        mass_c = jnp.asarray(mass, jnp.float32)
        f = self.force
        tau = gravity.pair_timescale_rows(
            pos_c, vel_c, mass_c, pos_c, vel_c, mass_c,
            jnp.asarray(f.eps, jnp.float32), jnp.asarray(f.G, jnp.float32),
            f.chunk,
            r_max=jnp.asarray(self.pair_r_max, jnp.float32)
            * jnp.asarray(f.eps, jnp.float32))
        return jnp.min(tau).astype(pos.dtype)

    def _aarseth_dt(self, a1, j1, a2_1, a3):
        return _aarseth_shared_dt(a1, j1, a2_1, a3, self.eta)

    def _step_with_dt(self, carry: HermiteCarry, dt):
        s, a0, j0 = carry.state, carry.acc, carry.jerk
        dt = jnp.asarray(dt, s.pos.dtype)
        dt2, dt3 = dt * dt, dt * dt * dt

        xp = s.pos + dt * s.vel + (dt2 / 2) * a0 + (dt3 / 6) * j0
        vp = s.vel + dt * a0 + (dt2 / 2) * j0

        # predictor/corrector evaluations happen at the step's END time
        force_t1 = self.force.at_time(s.time + dt)
        a1, j1 = force_t1.accel_jerk(xp, vp, s.mass)
        a1 = a1.astype(s.pos.dtype)
        j1 = j1.astype(s.pos.dtype)

        x1, v1 = _correct(s.pos, s.vel, a0, j0, a1, j1, dt)

        if self.pec2:
            # second corrector pass: re-evaluate at the corrected state and
            # re-apply the corrector from the same (a0, j0)
            a1, j1 = force_t1.accel_jerk(x1, v1, s.mass)
            a1 = a1.astype(s.pos.dtype)
            j1 = j1.astype(s.pos.dtype)
            x1, v1 = _correct(s.pos, s.vel, a0, j0, a1, j1, dt)

        # interpolated higher derivatives (at t0), then shift to t1
        a2_1, a3 = _interp_derivs(a0, j0, a1, j1, dt)

        # growth-limit against the CARRIED dt, not the executed one: the
        # executed dt may be a boundary-clipped landing step (advance_to),
        # and (a) capping growth at 2x a tiny clip would cripple the next
        # segment's restart, (b) the a2/a3 interpolation over a
        # nearly-degenerate (dt << carry.dt) pair is rounding noise, so a
        # landing step carries the previous dt forward unchanged.
        dt_new = self._aarseth_dt(a1, j1, a2_1, a3)
        dt_new = jnp.minimum(dt_new, 2.0 * carry.dt)
        dt_new = jnp.where(dt >= 0.25 * carry.dt, dt_new, carry.dt)
        if self.pair_dt:
            # cap by the encounter timescale at the step's END state
            dt_new = jnp.minimum(dt_new, self.eta_pair * self._pair_tau_min(
                x1, v1, s.mass))
        dt_new = self._shape_dt(dt_new)

        state_new = s.replace(pos=x1, vel=v1, time=s.time + dt)
        return HermiteCarry(state=state_new, acc=a1, jerk=j1, dt=dt_new,
                            n_steps=carry.n_steps + 1)

    def _exec_step(self, carry: HermiteCarry, dt_cap) -> HermiteCarry:
        """One step under an upper dt bound (the advance_to landing clip).

        symmetrized=True (Hut–Makino–McMillan): a TRIAL step at the
        carried dt yields the end-state criterion; the executed dt is the
        shaped average of start and end criteria, capped the same way.
        One fixed-point iteration suffices for the secular-drift
        cancellation (the residual asymmetry is O(dt²) of the criterion's
        variation — below the scheme's own dt⁴ error for any sane eta)."""
        dt = jnp.minimum(carry.dt, dt_cap)
        if not self.symmetrized:
            return self._step_with_dt(carry, dt)
        trial = self._step_with_dt(carry, dt)
        dt_s = jnp.minimum(
            self._shape_dt(0.5 * (carry.dt + trial.dt)), dt_cap)
        return self._step_with_dt(carry, dt_s)

    # ---- public -------------------------------------------------------
    def step(self, carry: HermiteCarry) -> HermiteCarry:
        return self._exec_step(carry, jnp.inf)

    def advance(self, carry: HermiteCarry, n: int) -> HermiteCarry:
        return jax.lax.fori_loop(0, n, lambda _, c: self.step(c), carry)

    def advance_to(self, carry: HermiteCarry, t_end) -> HermiteCarry:
        t_end = jnp.asarray(t_end, jnp.float64)

        def cond(c):
            return c.state.time < t_end * (1 - jnp.sign(t_end) * 1e-14) - 1e-300

        def body(c):
            return self._exec_step(c, t_end - c.state.time)

        return jax.lax.while_loop(cond, body, carry)

    def advance_to_bounded(self, carry: HermiteCarry, t_end,
                           max_steps: int) -> HermiteCarry:
        """advance_to with a per-dispatch step cap (driver loops on host)."""
        t_end = jnp.asarray(t_end, jnp.float64)
        start = carry.n_steps

        def cond(c):
            return (c.state.time < t_end * (1 - jnp.sign(t_end) * 1e-14)
                    - 1e-300) & (c.n_steps - start < max_steps)

        def body(c):
            return self._exec_step(c, t_end - c.state.time)

        return jax.lax.while_loop(cond, body, carry)

    def reached(self, carry: HermiteCarry, t_end) -> bool:
        # sign-safe form of the advance_to cond's tolerance: t_end*(1-eps)
        # moves toward zero for NEGATIVE t_end, which would leave reached()
        # false after advance_to stopped — an infinite driver loop
        te = float(t_end)
        return float(carry.state.time) >= te - 1e-14 * abs(te) - 1e-300

    def checkpoint_aux(self, carry: HermiteCarry) -> dict:
        return {"acc": carry.acc, "jerk": carry.jerk, "dt": carry.dt,
                "n_steps": carry.n_steps}

    def restore(self, state: ParticleState, aux: dict) -> HermiteCarry:
        if "acc" in aux and "jerk" in aux and "dt" in aux:
            # re-shape the checkpointed dt against THIS stepper's
            # dt_max/dt_min/quantize: resuming under a tighter dt_max must
            # not keep stepping at the old, larger dt until the next shrink
            # (VERDICT round-2 W7; contrast BlockHermite.restore, which
            # refuses grid changes outright)
            return HermiteCarry(
                state=state,
                acc=jnp.asarray(aux["acc"]),
                jerk=jnp.asarray(aux["jerk"]),
                dt=self._shape_dt(jnp.asarray(aux["dt"])),
                n_steps=jnp.asarray(aux.get("n_steps", 0), jnp.int64),
            )
        return self.init(state)


@dataclasses.dataclass(frozen=True)
class MacroHermite(Hermite4):
    """Host-stepped shared-dt Hermite-4 for N past the single-XLA-program
    window (the Hermite twin of leapfrog.MacroKDK).

    Each force evaluation runs as ``n_batches`` separate same-shape
    dispatches (ForceModel.accel_jerk_batched -> one-sided row chunks of
    the jerk sweep, f32 or extended tier); the predict / correct / timestep
    updates are small O(N) jitted programs between them. The adaptive-dt
    control flow that the in-jit stepper keeps inside lax.while_loop
    lives on the host here — the macro stepper is host-driven anyway, so
    per-step Python control costs a host round-trip that the force
    dispatches dwarf. Same carry/aux contract as Hermite4, so snapshots
    interchange with the in-jit stepper (kind "hermite"). Enable with
    ``integrator.macro_batches > 0`` and ``kind = "hermite"``."""

    n_batches: int = 8
    host_stepping: bool = True

    def __post_init__(self):
        super().__post_init__()
        if self.symmetrized:
            # the trial pass would double the already-dominant batched
            # force cost at macro N — and the knob targets binary-
            # dominated small-N systems, which is not this regime
            raise ValueError(
                "integrator.symmetrized is not supported with "
                "macro_batches (the trial pass doubles the batched force "
                "cost; the knob targets binary-dominated small-N runs)")
        # per-instance jitted O(N) programs (self is frozen/hashable; the
        # closures constant-fold eta/dt_min/dt_max/quantize at trace time)
        @jax.jit
        def predict(state, acc, jerk, dt):
            dt = jnp.asarray(dt, state.pos.dtype)
            dt2, dt3 = dt * dt, dt * dt * dt
            xp = state.pos + dt * state.vel + (dt2 / 2) * acc \
                + (dt3 / 6) * jerk
            vp = state.vel + dt * acc + (dt2 / 2) * jerk
            return xp, vp

        @jax.jit
        def correct(state, a0, j0, a1, j1, dt):
            dt = jnp.asarray(dt, state.pos.dtype)
            return _correct(state.pos, state.vel, a0, j0, a1, j1, dt)

        @jax.jit
        def finish(carry, x1, v1, a1, j1, dt):
            dt = jnp.asarray(dt, carry.state.pos.dtype)
            a2_1, a3 = _interp_derivs(carry.acc, carry.jerk, a1, j1, dt)
            # growth-limit vs the CARRIED dt + landing-step guard — same
            # rationale as Hermite4._step_with_dt
            dt_new = _aarseth_shared_dt(a1, j1, a2_1, a3, self.eta)
            dt_new = jnp.minimum(dt_new, 2.0 * carry.dt)
            dt_new = jnp.where(dt >= 0.25 * carry.dt, dt_new, carry.dt)
            dt_new = _shape_dt_fn(dt_new, self.dt_min, self.dt_max,
                                  self.quantize)
            state_new = carry.state.replace(pos=x1, vel=v1,
                                            time=carry.state.time + dt)
            return HermiteCarry(state=state_new, acc=a1, jerk=j1,
                                dt=dt_new, n_steps=carry.n_steps + 1)

        @jax.jit
        def init_dt(acc, jerk):
            a = _norm(acc)
            j = _norm(jerk)
            dt0 = self.eta_init * jnp.min(jnp.where(
                j > 0, a / jnp.maximum(j, jnp.finfo(a.dtype).tiny),
                jnp.inf))
            dt0 = jnp.minimum(dt0, self.dt_max)
            dt0 = jnp.where(jnp.isfinite(dt0), dt0,
                            jnp.asarray(self.dt_max))
            return _shape_dt_fn(dt0, self.dt_min, self.dt_max,
                                self.quantize)

        object.__setattr__(self, "_jit_predict", predict)
        object.__setattr__(self, "_jit_correct", correct)
        object.__setattr__(self, "_jit_finish", finish)
        object.__setattr__(self, "_jit_init_dt", init_dt)

    def _accel_jerk(self, pos, vel, mass, t):
        a, j = self.force.at_time(t).accel_jerk_batched(
            pos, vel, mass, n_batches=self.n_batches)
        return a.astype(pos.dtype), j.astype(pos.dtype)

    def init(self, state: ParticleState) -> HermiteCarry:
        acc, jerk = self._accel_jerk(state.pos, state.vel, state.mass,
                                     state.time)
        return HermiteCarry(state=state, acc=acc, jerk=jerk,
                            dt=self._jit_init_dt(acc, jerk),
                            n_steps=jnp.asarray(0, jnp.int64))

    def _host_step(self, carry: HermiteCarry, dt) -> HermiteCarry:
        t1 = carry.state.time + dt  # evaluations at the step's END time
        xp, vp = self._jit_predict(carry.state, carry.acc, carry.jerk, dt)
        a1, j1 = self._accel_jerk(xp, vp, carry.state.mass, t1)
        x1, v1 = self._jit_correct(carry.state, carry.acc, carry.jerk,
                                   a1, j1, dt)
        if self.pec2:
            a1, j1 = self._accel_jerk(x1, v1, carry.state.mass, t1)
            x1, v1 = self._jit_correct(carry.state, carry.acc, carry.jerk,
                                       a1, j1, dt)
        return self._jit_finish(carry, x1, v1, a1, j1, dt)

    # ---- public (host-driven; the in-jit loop methods do not apply) ----
    def step(self, carry: HermiteCarry) -> HermiteCarry:
        return self._host_step(carry, carry.dt)

    def advance(self, carry: HermiteCarry, n: int) -> HermiteCarry:
        for _ in range(n):
            carry = self.step(carry)
        return carry

    def advance_to(self, carry: HermiteCarry, t_end) -> HermiteCarry:
        return self.advance_to_bounded(carry, t_end, 10 ** 9)

    def advance_to_bounded(self, carry: HermiteCarry, t_end,
                           max_steps: int) -> HermiteCarry:
        done = 0
        t_end64 = jnp.asarray(t_end, jnp.float64)
        while (not self.reached(carry, t_end)) and done < max_steps:
            dt = jnp.minimum(carry.dt, t_end64 - carry.state.time)
            carry = self._host_step(carry, dt)
            done += 1
        return carry
