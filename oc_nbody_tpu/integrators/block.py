"""Block (individual power-of-two) timesteps, Hermite-4 scheme, fully jitted.

Capability parity: SURVEY.md §2.9c / §3.4 — BASELINE.json:10 "block
timesteps (masked active-particle integration)". Every particle carries its
own (t_i, dt_i) with dt_i = dt_max / 2^k, k < n_levels; each micro-step
advances the system to t_next = min(t_i + dt_i), predicts ALL particles
there (O(N)), evaluates forces only for the ACTIVE rows (t_i + dt_i ==
t_next) against all predicted sources, corrects and re-rungs the active
rows. There is NO host-side branching (BASELINE.json:5): activity is a mask,
and the active-row evaluation uses fixed-shape bucketed gathers —
`lax.switch` over power-of-two buffer sizes, `lax.top_k` to compact — so the
O(active × N) kernel cost shrinks with the active count while every shape
stays static.

**Integer time grid.** Per-particle times and steps are stored as int64
multiples of dt_min = dt_max / 2^(n_levels-1). Where float64 is emulated,
`2.0**(-k)` is NOT bit-exact, which breaks `t_i + dt_i == t_next`
equality matching (measured: duplicate near-equal rungs and straggler
activations). Integer bookkeeping makes activity masks, rung alignment
(`t % (2 dt) == 0`) and block synchronisation exact by construction —
physical times are derived as `t_origin + t_int * dt_min` only where
needed.

Rung rules (standard Makino–Aarseth block scheme):
  * shrink: any time, to the Aarseth-criterion rung (clamped to n_levels);
  * grow: one rung per step at most, and only when t_next is an exact
    multiple of the new, larger dt (integer alignment).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from oc_nbody_tpu.forces import ForceModel
from oc_nbody_tpu.state import ParticleState


def _norm(x):
    return jnp.sqrt(jnp.sum(x * x, axis=-1))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockCarry:
    state: ParticleState     # pos/vel at per-particle times; state.time = last t_next
    acc: jax.Array           # (N, 3) TOTAL acceleration at t_i
    jerk: jax.Array          # (N, 3) TOTAL jerk at t_i
    # external-field parts of acc/jerk at t_i, carried so the rung criterion
    # can be applied to the pairwise and external components SEPARATELY: on
    # galactic orbits |a_ext| >> |a_pair| (measured ~8 vs 0.1-1 in config 4)
    # and a total-force Aarseth dt is inflated by the smooth external field,
    # under-stepping the internal dynamics (measured 1e-2 E_int drift; the
    # split criterion removes it). Zero when there is no external field.
    a_ext: jax.Array         # (N, 3) at t_i
    j_ext: jax.Array         # (N, 3) at t_i
    t_i: jax.Array           # (N,) int64, units of dt_min, relative to t_origin
    dt_i: jax.Array          # (N,) int64 rung length in dt_min units (power of two)
    t_origin: jax.Array      # f64 scalar: physical time at t_int == 0
    n_steps: jax.Array       # int64 micro-step counter
    n_active_sum: jax.Array  # int64 total active-row evaluations (work metric)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BlockHermite:
    """Individual block-timestep Hermite-4 stepper (integer time grid)."""

    force: ForceModel
    eta: float = 0.02
    eta_init: float = 0.01
    dt_max: float = 1.0 / 16.0
    n_levels: int = 8
    # active-set compaction: bucket sizes are n >> l for l in 0..n_buckets-1
    # (0 disables compaction: masked full-row evaluation)
    n_buckets: int = 4
    # PEC²: a second (evaluate, correct) pass on the ACTIVE rows at their
    # corrected state — same scheme as Hermite4.pec2, restricted to the
    # active subset (the inactive sources stay at their prediction, which
    # is all the first pass saw too). Doubles the active-row force work.
    pec2: bool = False
    # pair-aware rung criterion: additionally cap each active row's dt at
    # eta_pair × its minimum softened two-body encounter timescale
    # (ops.gravity.pair_timescale_rows). The Aarseth criterion is built
    # from the AGGREGATE force, which VANISHES through the softened core
    # (a ∝ r there) — so eccentric hard pairs get their dt *grown* right
    # at pericentre, exactly where the encounter is fastest. Measured on
    # configs/binaries_8k.toml (round-4 VERDICT Missing #1): the
    # force-only criterion random-walks |dE/E_int| to ~3.5e-3 by t=6.5.
    pair_dt: bool = False
    eta_pair: float = 0.02
    # near-field window for the pair criterion, in units of eps (0 = no
    # window). The Aarseth criterion is blind only where softening bends
    # the force (r ≲ few eps); unwindowed, the nearest-neighbour fly-by
    # cap drags ~half the cluster 5+ rungs deeper for no accuracy gain
    # (measured on configs/binaries_8k.toml, bench/binaries_pairdt.py).
    pair_r_max: float = 4.0

    @property
    def dt_min(self) -> float:
        return self.dt_max / (1 << (self.n_levels - 1))

    @property
    def _dt_int_max(self) -> int:
        return 1 << (self.n_levels - 1)

    # ---- rung helpers (integer dt in dt_min units) ---------------------
    def _rung_from_float(self, dt_raw):
        """Largest power-of-two dt_int with dt_int*dt_min <= dt_raw (clamped
        to [1, 2^(n_levels-1)]). log2 is only a selector; the returned value
        is an exact integer."""
        x = dt_raw / self.dt_min
        p = jnp.floor(jnp.log2(jnp.maximum(x, 1.0)))
        p = jnp.clip(p, 0, self.n_levels - 1).astype(jnp.int64)
        return jnp.left_shift(jnp.int64(1), p)

    def _aarseth_dt(self, a, j, a2, a3):
        na, nj, n2, n3 = _norm(a), _norm(j), _norm(a2), _norm(a3)
        tiny = jnp.finfo(na.dtype).tiny
        num = na * n2 + nj * nj
        den = nj * n3 + n2 * n2
        dt = jnp.sqrt(self.eta * num / jnp.maximum(den, tiny))
        return jnp.where(den > 0, dt, jnp.inf)

    def _ext_parts(self, pos, vel, like, t):
        """(a_ext, j_ext) of the external field at physical time ``t`` —
        exact jvp incl. the bound-time ∂a/∂t term, O(N)."""
        if self.force.external is None:
            # two distinct buffers: aliased leaves break the driver's
            # donate_argnums superstep (donate-same-buffer-twice)
            return jnp.zeros_like(like), jnp.zeros_like(like)
        ext = self.force.external.at(t)
        a_ext, j_ext = ext.accel_jerk_ext(pos, vel)
        return a_ext.astype(like.dtype), j_ext.astype(like.dtype)

    @staticmethod
    def _interp_derivs(a0, j0, a1, j1, h, inv_h2, inv_h3):
        """Hermite-interpolated (a2 at t1, a3) from endpoint (a, j) pairs."""
        a2_0 = (-6.0 * (a0 - a1) - h * (4.0 * j0 + 2.0 * j1)) * inv_h2
        a3 = (12.0 * (a0 - a1) + 6.0 * h * (j0 + j1)) * inv_h3
        return a2_0 + h * a3, a3

    # ---- lifecycle ----------------------------------------------------
    def init(self, state: ParticleState) -> BlockCarry:
        acc, jerk = self.force.at_time(state.time).accel_jerk(
            state.pos, state.vel, state.mass)
        acc = acc.astype(state.pos.dtype)
        jerk = jerk.astype(state.pos.dtype)
        a_ext, j_ext = self._ext_parts(state.pos, state.vel, acc, state.time)

        def aj_dt(a_vec, j_vec):
            a = _norm(a_vec)
            j = _norm(j_vec)
            return jnp.where(
                j > 0, a / jnp.maximum(j, jnp.finfo(a.dtype).tiny), jnp.inf)

        # startup rung: per-component a/|j| timescales (pairwise AND
        # external), same split rationale as the step criterion
        dt_raw = self.eta_init * jnp.minimum(
            aj_dt(acc - a_ext, jerk - j_ext), aj_dt(a_ext, j_ext))
        if self.pair_dt:
            tau = self._pair_tau_rows(state.pos, state.vel, state.mass,
                                      state.pos, state.vel, state.mass)
            dt_raw = jnp.minimum(dt_raw, self.eta_pair * tau)
        dt_i = self._rung_from_float(dt_raw)
        n = state.n
        return BlockCarry(
            state=state, acc=acc, jerk=jerk, a_ext=a_ext, j_ext=j_ext,
            t_i=jnp.zeros((n,), jnp.int64), dt_i=dt_i,
            # copy=True: t_origin must not alias state.time (both would be
            # donated by the driver's donate_argnums superstep)
            t_origin=jnp.array(state.time, jnp.float64, copy=True),
            n_steps=jnp.asarray(0, jnp.int64),
            n_active_sum=jnp.asarray(0, jnp.int64),
        )

    # ---- the micro-step -----------------------------------------------
    def _bucket_sizes(self, n: int):
        if self.n_buckets <= 0:
            return [n]
        sizes = []
        b = 1 << (n - 1).bit_length()  # next pow2 >= n
        for _ in range(self.n_buckets):
            sizes.append(min(b, n))
            if b <= 64:
                break
            b //= 2
        return sizes

    def step(self, carry: BlockCarry) -> BlockCarry:
        s = carry.state
        pos, vel = s.pos, s.vel
        n = s.n
        t_next = jnp.min(carry.t_i + carry.dt_i)          # int64, exact
        active = (carry.t_i + carry.dt_i) == t_next       # exact int equality
        n_active = jnp.sum(active)
        dt_min = jnp.asarray(self.dt_min, jnp.float64)

        # predict ALL particles to t_next (O(N))
        d = ((t_next - carry.t_i).astype(jnp.float64) * dt_min)[:, None]
        d2, d3 = d * d, d * d * d
        xp = pos + d * vel + (d2 / 2) * carry.acc + (d3 / 6) * carry.jerk
        vp = vel + d * carry.acc + (d2 / 2) * carry.jerk

        # evaluate (a1, j1) on active rows, sources = all predicted;
        # all evaluations in this step happen at physical time t_phys
        t_phys = carry.t_origin + t_next.astype(jnp.float64) * dt_min
        force_t = self.force.at_time(t_phys)
        a1_full, j1_full = self._eval_active(force_t, xp, vp, s.mass,
                                             active, n)

        # correct active rows over their own step h = dt_i * dt_min
        h = (carry.dt_i.astype(jnp.float64) * dt_min)[:, None]
        h2 = h * h
        a0, j0 = carry.acc, carry.jerk
        v1 = vel + (h / 2) * (a0 + a1_full) + (h2 / 12) * (j0 - j1_full)
        x1 = pos + (h / 2) * (vel + v1) + (h2 / 12) * (a0 - a1_full)

        # state at which a1_full/j1_full were evaluated (the pec2 branch
        # moves it): the ext parts below must use the SAME state, or the
        # pairwise split a1p = a1_full − a_ext1 mixes evaluation points
        xe, ve = xp, vp
        if self.pec2:
            # re-evaluate at the corrected active rows (inactive sources
            # keep their prediction — identical to what pass 1 saw) and
            # iterate the corrector once toward its fixed point
            am0 = active[:, None]
            xp2 = jnp.where(am0, x1, xp)
            vp2 = jnp.where(am0, v1, vp)
            a1_full, j1_full = self._eval_active(force_t, xp2, vp2,
                                                 s.mass, active, n)
            v1 = vel + (h / 2) * (a0 + a1_full) + (h2 / 12) * (j0 - j1_full)
            x1 = pos + (h / 2) * (vel + v1) + (h2 / 12) * (a0 - a1_full)
            xe, ve = xp2, vp2

        # new rung: Aarseth criterion applied to the pairwise and external
        # force components SEPARATELY (see BlockCarry docstring), rung = min.
        # a2/a3 per component come from the same Hermite interpolation,
        # using the stored t_i endpoint ext parts and fresh t_next ones.
        inv_h2 = 1.0 / h2
        inv_h3 = inv_h2 / h
        a_ext1, j_ext1 = self._ext_parts(xe, ve, a1_full, t_phys)
        a0p, j0p = a0 - carry.a_ext, j0 - carry.j_ext
        a1p, j1p = a1_full - a_ext1, j1_full - j_ext1
        p2_1, p3 = self._interp_derivs(a0p, j0p, a1p, j1p, h, inv_h2, inv_h3)
        e2_1, e3 = self._interp_derivs(carry.a_ext, carry.j_ext,
                                       a_ext1, j_ext1, h, inv_h2, inv_h3)
        dt_raw = jnp.minimum(self._aarseth_dt(a1p, j1p, p2_1, p3),
                             self._aarseth_dt(a_ext1, j_ext1, e2_1, e3))
        if self.pair_dt:
            tau = self._pair_tau_active(xe, ve, s.mass, active, n)
            dt_raw = jnp.minimum(dt_raw, self.eta_pair * tau)
        dt_want = self._rung_from_float(dt_raw)
        # grow at most one rung, only when aligned with the block grid
        dt_grow = 2 * carry.dt_i
        aligned = (t_next % dt_grow) == 0
        dt_new = jnp.where(
            dt_want >= dt_grow,
            jnp.where(aligned, jnp.minimum(dt_grow, self._dt_int_max),
                      carry.dt_i),
            jnp.minimum(dt_want, carry.dt_i),
        )

        am = active[:, None]
        state_new = s.replace(
            pos=jnp.where(am, x1, pos),
            vel=jnp.where(am, v1, vel),
            time=carry.t_origin + t_next.astype(jnp.float64) * dt_min,
        )
        return carry.replace(
            state=state_new,
            acc=jnp.where(am, a1_full, a0),
            jerk=jnp.where(am, j1_full, j0),
            a_ext=jnp.where(am, a_ext1, carry.a_ext),
            j_ext=jnp.where(am, j_ext1, carry.j_ext),
            t_i=jnp.where(active, t_next, carry.t_i),
            dt_i=jnp.where(active, dt_new, carry.dt_i),
            n_steps=carry.n_steps + 1,
            n_active_sum=carry.n_active_sum + n_active.astype(jnp.int64),
        )

    def _eval_active(self, force, xp, vp, mass, active, n):
        """(a1, j1) for active rows (zeros elsewhere), fixed shapes.
        ``force`` is the (possibly time-bound) force model for this step."""
        sizes = self._bucket_sizes(n)
        # escape pruning: the per-row membership rides along so the
        # rows-vs-sources eval keeps the reduced-Hamiltonian contract
        # (cluster rows × all sources, tail rows × cluster bucket)
        pmask = force.src_mask if getattr(force, "pruned", False) else None
        if len(sizes) == 1:
            a1, j1 = force.accel_jerk_on_rows(xp, vp, xp, vp, mass,
                                              rows_mask=pmask)
            return a1, j1

        n_active = jnp.sum(active)
        # smallest bucket that fits the active count
        level = jnp.int32(0)
        for li, b in enumerate(sizes):
            level = jnp.where(n_active <= b, jnp.int32(li), level)

        def make_branch(b):
            def branch(xp, vp, mass, active):
                # top_k(active) puts active rows first (ties keep original
                # order): fixed-size compaction without nonzero's cumsum
                # or a bool sort.
                _, idx = jax.lax.top_k(active.astype(jnp.int32), b)
                valid = jnp.arange(b) < jnp.sum(active)
                # fill rows (inactive, results discarded) carry a 0.5
                # "don't-care" membership so they can't force the pruned
                # eval's mixed (both-sweeps) branch (forces.py cost note)
                rmask = None if pmask is None else jnp.where(
                    valid, pmask[idx], 0.5)
                a_r, j_r = force.accel_jerk_on_rows(
                    xp[idx], vp[idx], xp, vp, mass, rows_mask=rmask)
                # scatter via an overflow row so fill slots never clobber
                idx_s = jnp.where(valid, idx, n)
                a_full = jnp.zeros((n + 1, 3), xp.dtype).at[idx_s].set(a_r)[:n]
                j_full = jnp.zeros((n + 1, 3), xp.dtype).at[idx_s].set(j_r)[:n]
                return a_full, j_full

            return branch

        return jax.lax.switch(level, [make_branch(b) for b in sizes],
                              xp, vp, mass, active)

    # ---- pair-aware rung criterion -------------------------------------
    def _pair_tau_rows(self, pos_rows, vel_rows, mass_rows, src_pos,
                       src_vel, src_mass):
        """Per-row softened encounter timescale vs the full source set,
        centred on the source means before the f32 cast (the timescale
        only PICKS rungs, so f32 is ample; centring keeps the mantissa on
        galactocentric orbits — same discipline as the force kernels)."""
        from oc_nbody_tpu.ops import gravity
        center = jnp.mean(src_pos, axis=0)
        vcenter = jnp.mean(src_vel, axis=0)
        f = self.force
        tau = gravity.pair_timescale_rows(
            (pos_rows - center).astype(jnp.float32),
            (vel_rows - vcenter).astype(jnp.float32),
            jnp.asarray(mass_rows, jnp.float32),
            (src_pos - center).astype(jnp.float32),
            (src_vel - vcenter).astype(jnp.float32),
            jnp.asarray(src_mass, jnp.float32),
            jnp.asarray(f.eps, jnp.float32), jnp.asarray(f.G, jnp.float32),
            f.chunk,
            r_max=jnp.asarray(self.pair_r_max, jnp.float32)
            * jnp.asarray(f.eps, jnp.float32))
        return tau.astype(pos_rows.dtype)

    def _pair_tau_active(self, xp, vp, mass, active, n):
        """tau for the active rows (inf elsewhere), same fixed-shape
        bucketed compaction as _eval_active (an O(active × N) min-sweep,
        ~1/5 the flops of the force+jerk eval it rides alongside)."""
        sizes = self._bucket_sizes(n)
        inf = jnp.asarray(jnp.inf, xp.dtype)
        if len(sizes) == 1:
            tau = self._pair_tau_rows(xp, vp, mass, xp, vp, mass)
            return jnp.where(active, tau, inf)

        n_active = jnp.sum(active)
        level = jnp.int32(0)
        for li, b in enumerate(sizes):
            level = jnp.where(n_active <= b, jnp.int32(li), level)

        def make_branch(b):
            def branch(xp, vp, mass, active):
                _, idx = jax.lax.top_k(active.astype(jnp.int32), b)
                valid = jnp.arange(b) < jnp.sum(active)
                tau_r = self._pair_tau_rows(xp[idx], vp[idx], mass[idx],
                                            xp, vp, mass)
                idx_s = jnp.where(valid, idx, n)
                return jnp.full((n + 1,), inf, xp.dtype).at[idx_s].set(
                    jnp.where(valid, tau_r, inf))[:n]

            return branch

        return jax.lax.switch(level, [make_branch(b) for b in sizes],
                              xp, vp, mass, active)

    # ---- driving ------------------------------------------------------
    def _t_end_int(self, carry: BlockCarry, t_end):
        rel = (jnp.asarray(t_end, jnp.float64) - carry.t_origin) / self.dt_min
        return jnp.round(rel).astype(jnp.int64)

    def advance_to(self, carry: BlockCarry, t_end) -> BlockCarry:
        """Micro-step until every particle reaches t_end. ``t_end`` must lie
        on the dt_max block grid so the system synchronises there."""
        te = self._t_end_int(carry, t_end)

        def cond(c):
            return jnp.min(c.t_i + c.dt_i) <= te

        return jax.lax.while_loop(cond, lambda c: self.step(c), carry)

    def advance_to_bounded(self, carry: BlockCarry, t_end,
                           max_steps: int) -> BlockCarry:
        """Like advance_to but caps the micro-steps in this dispatch — very
        long single XLA dispatches can trip runtime watchdogs; the driver
        loops on the host until t_end is reached (SURVEY.md §5 failure
        detection)."""
        te = self._t_end_int(carry, t_end)
        start = carry.n_steps

        def cond(c):
            return (jnp.min(c.t_i + c.dt_i) <= te) & (
                c.n_steps - start < max_steps)

        return jax.lax.while_loop(cond, lambda c: self.step(c), carry)

    def reached(self, carry: BlockCarry, t_end) -> bool:
        te = self._t_end_int(carry, t_end)
        return bool(jnp.min(carry.t_i + carry.dt_i) > te)

    def advance(self, carry: BlockCarry, n: int) -> BlockCarry:
        return jax.lax.fori_loop(0, n, lambda _, c: self.step(c), carry)

    def rung_occupancy(self, carry: BlockCarry) -> jax.Array:
        """Particle count per rung k (dt = dt_max/2^k), shape (n_levels,).

        The per-rung histogram the block scheme's work model needs
        (SURVEY.md §2.9b; VERDICT round-1 item 7): total force work per
        dt_max block is sum_k occ[k] * 2^k row-evaluations.
        """
        # dt_i = 2^(n_levels-1-k) in dt_min units; exact integer match
        dt_ints = jnp.left_shift(
            jnp.int64(1), jnp.arange(self.n_levels - 1, -1, -1, dtype=jnp.int64))
        return jnp.sum(carry.dt_i[None, :] == dt_ints[:, None], axis=1)

    def checkpoint_aux(self, carry: BlockCarry) -> dict:
        return {"acc": carry.acc, "jerk": carry.jerk,
                "a_ext": carry.a_ext, "j_ext": carry.j_ext,
                "t_i": carry.t_i,
                "dt_i": carry.dt_i, "t_origin": carry.t_origin,
                "n_steps": carry.n_steps, "n_active_sum": carry.n_active_sum,
                "dt_max": jnp.asarray(self.dt_max, jnp.float64),
                "n_levels": jnp.asarray(self.n_levels, jnp.int64)}

    def restore(self, state: ParticleState, aux: dict) -> BlockCarry:
        # t_i/dt_i are integers in units of THIS stepper's dt_min: resuming
        # with a different dt_max or n_levels would silently rescale every
        # per-particle time (ADVICE round-1). Exception (round-5, flagship
        # stepping studies): when the checkpoint grid embeds EXACTLY in the
        # configured one — old dt_min an exact power-of-two multiple of the
        # new — rescale t_i/dt_i by that integer factor (exact in int64;
        # alignment and power-of-two rungs are preserved by construction,
        # dt_i clamps at the new dt_max). Coarsening is still refused.
        rescale = 1
        if "dt_max" in aux and "n_levels" in aux:
            old_dt_min = float(aux["dt_max"]) / (1 << (int(aux["n_levels"])
                                                       - 1))
            ratio = old_dt_min / self.dt_min
            if abs(ratio - round(ratio)) < 1e-9 and round(ratio) >= 1 and (
                    round(ratio) & (round(ratio) - 1)) == 0:
                rescale = int(round(ratio))
            else:
                raise ValueError(
                    f"checkpoint block grid (dt_max={float(aux['dt_max'])}, "
                    f"n_levels={int(aux['n_levels'])}, dt_min={old_dt_min}) "
                    f"does not embed in the configured grid (dt_max="
                    f"{self.dt_max}, n_levels={self.n_levels}, dt_min="
                    f"{self.dt_min}): old dt_min must be a power-of-two "
                    "multiple of the new (refining is exact; coarsening "
                    "would corrupt per-particle times)")
        if all(k in aux for k in ("acc", "jerk", "t_i", "dt_i", "t_origin")):
            acc = jnp.asarray(aux["acc"])
            if "a_ext" in aux and "j_ext" in aux:
                a_ext = jnp.asarray(aux["a_ext"])
                j_ext = jnp.asarray(aux["j_ext"])
            else:
                # pre-round-2 checkpoint: ext parts are a pure function of
                # (pos, vel), recompute exactly
                a_ext, j_ext = self._ext_parts(state.pos, state.vel, acc,
                                               state.time)
            dt_i = jnp.asarray(aux["dt_i"], jnp.int64) * rescale
            dt_i = jnp.minimum(dt_i, self._dt_int_max)  # both powers of two
            return BlockCarry(
                state=state,
                acc=acc, jerk=jnp.asarray(aux["jerk"]),
                a_ext=a_ext, j_ext=j_ext,
                t_i=jnp.asarray(aux["t_i"], jnp.int64) * rescale,
                dt_i=dt_i,
                t_origin=jnp.asarray(aux["t_origin"], jnp.float64),
                n_steps=jnp.asarray(aux.get("n_steps", 0), jnp.int64),
                n_active_sum=jnp.asarray(aux.get("n_active_sum", 0), jnp.int64),
            )
        return self.init(state)
