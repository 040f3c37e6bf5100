"""Stellar evolution: analytic mass loss (winds → remnants) + natal kicks.

Capability extension beyond the SURVEY.md §2 inventory (the reference tree
is empty — SURVEY.md §0; BASELINE.json lists no stellar-evolution
capability): open-cluster N-body codes of this class (NBODY6, PeTar,
McLuster pipelines) pair the dynamics with a stellar-evolution
prescription, because early mass loss from massive stars is the dominant
driver of cluster expansion and dissolution in the first ~100 Myr. This
module provides the standard minimal prescription:

* an analytic main-sequence lifetime t_MS(m) (smooth two-power
  interpolation calibrated to solar-metallicity tracks: 8.5 Gyr at
  1 M☉, 85 Myr at 5 M☉, 22 Myr at 10 M☉, 3.1 Myr at 100 M☉);
* an initial–final mass relation: white dwarfs below ``m_ns_min_msun``
  (Kalirai-style linear IFMR 0.109 m + 0.394), neutron stars of fixed
  mass up to ``m_bh_min_msun``, black holes above (0.1 m + 1.0);
* optional isotropic natal kicks per remnant class (Maxwellian —
  per-component Gaussian of the configured σ), applied exactly once at
  the death time;
* optional continuous winds (``wind_fraction``): that fraction of each
  star's total loss leaves as a linear-in-time wind over the last
  ``wind_time_frac`` of its life, the remainder dropping at collapse —
  the NBODY6-style winds+supernova split, with the same zero-extra-state
  machinery (see below).

Device-first design: the death times, remnant masses, and kick vectors are
all PRECOMPUTED host-side at scene build (O(N), f64 numpy) into a
``SEVTables`` pytree; the runtime update is one O(N) elementwise pass —
no data-dependent control flow, no host branching, and **idempotent**:
``mass = min(mass, target(t))`` against a deterministic MONOTONE
per-star target (m_init → wind ramp → m_rem), plus a "newly dead" mask
derived from the CURRENT mass (a star is kicked iff it is past its
death time but its state mass still exceeds the midpoint between
pre-collapse and remnant mass). Idempotence is what makes
checkpoint/resume exact without persisting any extra mutable state: the
tables are rebuilt deterministically from the config (same IC seed →
same masses → same tables; kicks drawn from the scene's persisted
forward RNG stream), and re-applying the update to a restored state is a
no-op. The driver (run.py) applies the update at every diagnostics
boundary — masses are piecewise-constant in time between boundaries, so
the energy budget closes exactly: E_tot jumps only at accounted updates,
and the driver's ``E_sev_cum`` column integrates those jumps so that
``E_tot − E_sev_cum`` is the conserved quantity (tested in
tests/physics/test_stellar_evolution_run.py).

Physical-mass convention: a star's physical mass is
``m_code * units.mass_msun`` (models/plummer.py rescales IMF draws to
``ic.total_mass`` code units, so with total_mass = 1 the cluster's
physical mass IS ``units.mass_msun``). For realistic lifetimes set
``units.mass_msun ≈ n · ⟨m⟩_IMF`` (⟨m⟩ ≈ 0.58 M☉ for Kroupa 0.08–100).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ms_lifetime_myr", "remnant_mass_msun", "SEVTables",
    "StellarEvolution", "make_stellar_evolution",
]


def ms_lifetime_myr(m_msun):
    """Main-sequence lifetime [Myr] of a star of initial mass ``m_msun``.

    Smooth interpolation  t = (2550 + 667 m^2.5 + m^4.5) /
    (0.0327 m^1.5 + 0.346 m^4.5)  — the classic analytic MS-lifetime fit
    for solar metallicity. Endpoints (validated in
    tests/unit/test_stellar_evolution.py): 8.5 Gyr at 1 M☉, 801 Myr at
    2 M☉, 85 Myr at 5 M☉, 22.4 Myr at 10 M☉, 3.1 Myr at 100 M☉;
    asymptotes to 1/0.346 ≈ 2.9 Myr for very massive stars and to
    ∝ m^−1.5 below ~0.5 M☉. Monotone decreasing. Works on numpy or jnp
    arrays (f64 recommended: lifetimes span 7 decades)."""
    xp = jnp if isinstance(m_msun, jax.Array) else np
    m = xp.asarray(m_msun, xp.float64)
    m15 = m * xp.sqrt(m)
    m25 = m * m15
    m45 = m25 * m * m
    return (2550.0 + 667.0 * m25 + m45) / (0.0327 * m15 + 0.346 * m45)


def remnant_mass_msun(m_msun, m_ns_min: float = 8.0,
                      m_bh_min: float = 20.0, m_ns: float = 1.4):
    """Initial–final mass relation [M☉] (toy, standard knobs).

    * m < m_ns_min:  white dwarf, 0.109 m + 0.394 (Kalirai et al. 2008
      linear IFMR — 0.50 M☉ at 1 M☉, 1.27 M☉ at 8 M☉, < M_Chandrasekhar
      throughout the WD range);
    * m_ns_min ≤ m < m_bh_min: neutron star of fixed mass ``m_ns``;
    * m ≥ m_bh_min: black hole, 0.1 m + 1.0 (3 M☉ at 20, 11 M☉ at 100 —
      a fallback-style toy relation).
    """
    xp = jnp if isinstance(m_msun, jax.Array) else np
    m = xp.asarray(m_msun, xp.float64)
    wd = 0.109 * m + 0.394
    bh = 0.1 * m + 1.0
    return xp.where(m < m_ns_min, wd, xp.where(m < m_bh_min, m_ns, bh))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SEVTables:
    """Per-star death schedule, precomputed once (all code units)."""

    t_death: jax.Array   # (N,) f64 code time of death (may be ≤ 0: dead at start)
    t_wind: jax.Array    # (N,) f64 wind onset (== t_death when winds off)
    m_rem: jax.Array     # (N,) f32 remnant mass
    m_pre: jax.Array     # (N,) f32 pre-collapse mass (m_init − wind loss)
    m_mid: jax.Array     # (N,) f32 midpoint (m_pre + m_rem)/2 — "kick not yet applied" test
    kicks: jax.Array     # (N,3) f64 natal kick velocity (zero rows when σ = 0)
    m_init: jax.Array    # (N,) f32 initial mass (wind interpolation anchor)
    m_init_sum: jax.Array  # f64 scalar: Σ m_init (for the dM_sev column)


def _mass_target(state_time, tables: SEVTables):
    """Deterministic per-star target mass at time t (f32, MONOTONE in t):
    m_init before the wind onset, linear wind erosion to m_pre over
    [t_wind, t_death], m_rem from t_death on."""
    span = jnp.maximum(tables.t_death - tables.t_wind, 1e-300)
    frac = jnp.clip((state_time - tables.t_wind) / span, 0.0, 1.0)
    m_init64 = tables.m_init.astype(jnp.float64)
    windy = m_init64 + frac * (tables.m_pre.astype(jnp.float64) - m_init64)
    target = jnp.where(state_time >= tables.t_death,
                       tables.m_rem.astype(jnp.float64), windy)
    return target.astype(tables.m_rem.dtype)


def _update(state, tables: SEVTables):
    """Advance every star to its target mass at state.time. Pure and
    IDEMPOTENT: ``mass := min(mass, target(t))`` with a monotone target,
    so re-running the update (e.g. after a resume) changes nothing.

    Returns (new_state, n_newly_dead). A star receives its natal kick
    exactly once, at the collapse jump: it is past t_death but its mass
    still reads above the (m_pre + m_rem)/2 midpoint."""
    newly = (state.time >= tables.t_death) & (state.mass > tables.m_mid)
    mass = jnp.minimum(state.mass, _mass_target(state.time, tables))
    vel = state.vel + jnp.where(newly[:, None],
                                tables.kicks.astype(state.vel.dtype), 0.0)
    return (state.replace(mass=mass.astype(state.mass.dtype), vel=vel),
            jnp.sum(newly.astype(jnp.int32)))


def _count_pending(state, tables: SEVTables):
    """Stars whose mass is above their current target (wind erosion due
    or collapse not yet applied). The relative slack keeps an
    already-updated (f32-exact) state from re-triggering."""
    target = _mass_target(state.time, tables)
    return jnp.sum((state.mass > target
                    + 1e-6 * tables.m_init).astype(jnp.int32))


# jitted once at module level: wrapping in the method would build a fresh
# jit wrapper (and pay a Python retrace) at every diagnostics boundary
_update_jit = jax.jit(_update)
_count_pending_jit = jax.jit(_count_pending)


@dataclasses.dataclass(frozen=True)
class StellarEvolution:
    """Jitted wrapper the driver calls at diagnostics boundaries."""

    tables: SEVTables

    def count_pending(self, state) -> jax.Array:
        """Number of stars past t_death whose mass is not yet updated
        (O(N), one tiny host transfer — the driver skips the O(N²)
        energy bookkeeping and carry rebuild when this is zero)."""
        return _count_pending_jit(state, self.tables)

    def update(self, state):
        """Apply pending deaths; returns the new state."""
        return _update_jit(state, self.tables)[0]

    # diagnostics helpers (host-side, cheap)
    def n_dead(self, state) -> int:
        """Stars that have completed their collapse (mass at/below the
        midpoint). Stars whose clamped "remnant" equals their initial
        mass (very low-mass: the Kalirai IFMR exceeds m for
        m ≲ 0.44 M☉, so min(m_rem, m) = m) never transition — without
        the real-jump guard they would all count as remnants from t=0."""
        real = self.tables.m_rem < self.tables.m_init * (1.0 - 1e-6)
        dead = jnp.asarray(state.mass) <= self.tables.m_mid
        return int(jnp.sum((real & dead).astype(jnp.int32)))

    def mass_lost(self, state) -> float:
        """Cumulative mass lost to stellar evolution (code units)."""
        cur = jnp.sum(jnp.asarray(state.mass, jnp.float64))
        return float(self.tables.m_init_sum - cur)


def make_stellar_evolution(sev_cfg, units, state, rng_key) -> StellarEvolution:
    """Build the death-schedule tables from the FRESH-IC state.

    Must be called with the scene's freshly built state (run.py does) —
    on resume the restored state already carries remnant masses, and the
    tables must describe the progenitors. Deterministic: same config →
    same tables (kicks come from the scene's persisted forward RNG
    stream, fold_in-separated from every other consumer)."""
    m_init_code = np.asarray(state.mass, np.float64)
    m_msun = m_init_code * units.mass_msun
    t_ms = ms_lifetime_myr(m_msun)                               # Myr
    t_death = units.to_code(t_ms - sev_cfg.epoch0_myr, "time")   # code units
    m_rem_msun = remnant_mass_msun(
        m_msun, m_ns_min=sev_cfg.m_ns_min_msun,
        m_bh_min=sev_cfg.m_bh_min_msun, m_ns=sev_cfg.m_ns_msun)
    # a "remnant" can never be heavier than its progenitor (the fixed-m_ns
    # branch would otherwise ADD mass to an 8 M☉-code star in a unit
    # system where that maps below 1.4 M☉)
    m_rem_msun = np.minimum(m_rem_msun, m_msun)
    m_rem_code = m_rem_msun / units.mass_msun

    # winds: a fraction of each star's total loss leaves as a linear wind
    # over the last wind_time_frac of its life; the rest drops at collapse
    w = float(sev_cfg.wind_fraction)
    if not 0.0 <= w <= 1.0:
        raise ValueError(f"sev.wind_fraction must be in [0,1], got {w}")
    any_kick = max(sev_cfg.kick_sigma_wd_kms, sev_cfg.kick_sigma_ns_kms,
                   sev_cfg.kick_sigma_bh_kms) > 0
    if any_kick and w > 0.9:
        # the exactly-once kick trigger is the collapse mass jump
        # (m_pre -> m_rem crossing the midpoint); w = 1 erases the jump
        # and w -> 1 shrinks it below f32 mass resolution
        raise ValueError(
            "sev.wind_fraction > 0.9 with natal kicks configured: kicks "
            "trigger on the collapse mass jump, which needs >= 10% of "
            "the mass loss to happen at death")
    m_pre_code = m_init_code - w * (m_init_code - m_rem_code)
    tf = float(sev_cfg.wind_time_frac)
    if not 0.0 < tf <= 1.0:
        raise ValueError(f"sev.wind_time_frac must be in (0,1], got {tf}")
    t_wind = (t_death - tf * units.to_code(t_ms, "time")) if w > 0 \
        else np.asarray(t_death)

    sigma_kms = np.where(
        m_msun < sev_cfg.m_ns_min_msun, sev_cfg.kick_sigma_wd_kms,
        np.where(m_msun < sev_cfg.m_bh_min_msun, sev_cfg.kick_sigma_ns_kms,
                 sev_cfg.kick_sigma_bh_kms))
    sigma_code = units.to_code(sigma_kms, "velocity")
    if np.any(sigma_code > 0):
        key = jax.random.fold_in(jnp.asarray(rng_key, jnp.uint32), 0x534556)
        kicks = (jnp.asarray(sigma_code, jnp.float64)[:, None]
                 * jax.random.normal(key, (state.n, 3), jnp.float64))
    else:
        kicks = jnp.zeros((state.n, 3), jnp.float64)

    tables = SEVTables(
        t_death=jnp.asarray(t_death, jnp.float64),
        t_wind=jnp.asarray(t_wind, jnp.float64),
        m_rem=jnp.asarray(m_rem_code, jnp.float32),
        m_pre=jnp.asarray(m_pre_code, jnp.float32),
        m_mid=jnp.asarray(0.5 * (m_pre_code + m_rem_code), jnp.float32),
        kicks=kicks,
        m_init=jnp.asarray(m_init_code, jnp.float32),
        m_init_sum=jnp.asarray(m_init_code.sum(), jnp.float64),
    )
    return StellarEvolution(tables=tables)
