"""On-device diagnostics: energies, angular momentum, Lagrangian radii,
density centre, bound mass (energy cut and iterative tidal-radius cut).

Capability parity: SURVEY.md §2.11 — BASELINE.json:5 "on-device diagnostics
(energy, angular momentum, Lagrangian radii, bound-mass via iterative
tidal-radius cut)". Everything here is a pure jnp function (jit-safe,
fixed shapes, fori/while loops only); accumulations are float64.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from oc_nbody_tpu.forces import ForceModel
from oc_nbody_tpu.state import ParticleState


def kinetic_energy(state: ParticleState) -> jax.Array:
    m = state.mass.astype(jnp.float64)
    v2 = jnp.sum(state.vel.astype(jnp.float64) ** 2, axis=1)
    return 0.5 * jnp.sum(m * v2)


def energies(state: ParticleState, force: ForceModel,
             f64_pairwise: bool = False, precomputed_phi=None) -> dict:
    """KE, pairwise PE, external potential energy, total. All f64 scalars.

    ``E_int`` is the cluster-internal energy — KE in the mass-weighted COM
    velocity frame plus the pairwise PE. On orbit runs E_tot is dominated by
    the galactic well (|E_ext| >> |E_int|), so |dE/E_tot| flatters the drift
    by orders of magnitude; the spec's per-crossing target is about the
    CLUSTER, so the driver also reports dE normalised by |E_int(t=0)|
    (VERDICT round-1 item 4 / W6).

    Time-dependent externals are bound at state.time — the energy row is
    the instantaneous E(t) (not conserved when the field varies; see
    jacobi_energy for the rotating-pattern conserved quantity).
    """
    force = force.at_time(state.time)  # no-op for static externals
    m = state.mass.astype(jnp.float64)
    if precomputed_phi is not None:
        # oversized-eval path (MacroKDK): the O(N²) potential was computed
        # outside this jit by the batched chunked kernels — the one part
        # of the row a single XLA program cannot hold at N ≳ 4M
        phi_pair, phi_ext = precomputed_phi
    elif f64_pairwise:
        # diagnostic-grade pairwise potential: full (emulated) f64 pair
        # terms via the jnp oracle path. ~15x the f32 kernel cost — opt-in
        # (output.diag_f64) for acceptance runs where the f32 potential's
        # ~2e-7 noise floor would contaminate the dE_over_E_int series.
        from oc_nbody_tpu.ops import gravity
        _, phi_pair = gravity.accel_potential(
            state.pos, state.mass, force.eps, force.G,
            compute_dtype=jnp.float64, chunk=512)
        phi_ext = (force.external.phi(state.pos) if force.external is not None
                   else jnp.zeros_like(phi_pair))
    else:
        _, phi_pair, phi_ext = force.accel_potential(state.pos, state.mass)
    ke = kinetic_energy(state)
    # Under escape pruning the per-star phi is MIXED (cluster rows: all
    # sources; tail rows: cluster sources only) and the uniform 1/2 weight
    # sums it exactly to the reduced Hamiltonian's pair term PE_CC + PE_CT
    # (tail–tail dropped): sum_C m·phi_full = 2·PE_CC + PE_CT and
    # sum_T m·phi_cl = PE_CT (forces.ForceModel pruned dispatch).
    pe_pair = 0.5 * jnp.sum(m * phi_pair.astype(jnp.float64))
    e_ext = jnp.sum(m * phi_ext.astype(jnp.float64))
    vel = state.vel.astype(jnp.float64)
    vbar = jnp.sum(vel * m[:, None], axis=0) / jnp.sum(m)
    ke_int = 0.5 * jnp.sum(m * jnp.sum((vel - vbar) ** 2, axis=1))
    return {
        "KE": ke,
        "PE_pair": pe_pair,
        "E_ext": e_ext,
        "E_tot": ke + pe_pair + e_ext,
        "E_int": ke_int + pe_pair,
    }


def angular_momentum(state: ParticleState, center=None, center_vel=None) -> jax.Array:
    """Total L = sum m (r - c) x (v - vc), (3,) float64."""
    pos = state.pos.astype(jnp.float64)
    vel = state.vel.astype(jnp.float64)
    if center is not None:
        pos = pos - center
    if center_vel is not None:
        vel = vel - center_vel
    m = state.mass.astype(jnp.float64)
    return jnp.sum(m[:, None] * jnp.cross(pos, vel), axis=0)


def density_center(state: ParticleState, n_iter: int = 24,
                   shrink: float = 0.9, min_frac: float = 0.05) -> jax.Array:
    """Shrinking-sphere density centre (Casertano–Hut-style), branch-free.

    Iteratively recentres on the mass inside a shrinking sphere; stops
    shrinking (keeps the last good centre) once the enclosed mass fraction
    drops below ``min_frac``.
    """
    pos = state.pos.astype(jnp.float64)
    m = state.mass.astype(jnp.float64)
    m_tot = jnp.sum(m)

    c0 = jnp.sum(pos * m[:, None], axis=0) / m_tot
    r0 = jnp.max(jnp.linalg.norm(pos - c0, axis=1))

    def body(_, carry):
        c, r = carry
        d = jnp.linalg.norm(pos - c, axis=1)
        w = m * (d < r)
        wsum = jnp.sum(w)
        ok = wsum > min_frac * m_tot
        c_new = jnp.where(
            ok, jnp.sum(pos * w[:, None], axis=0) / jnp.maximum(wsum, 1e-300), c
        )
        r_new = jnp.where(ok, r * shrink, r)
        return (c_new, r_new)

    c, _ = jax.lax.fori_loop(0, n_iter, body, (c0, r0))
    return c


def lagrangian_radii(state: ParticleState, fractions=(0.1, 0.25, 0.5, 0.75, 0.9),
                     center=None, mask=None) -> jax.Array:
    """Radii enclosing the given mass fractions, about ``center``
    (default: density centre). ``mask`` restricts to a subset (e.g. bound
    stars) without changing shapes."""
    if center is None:
        center = density_center(state)
    pos = state.pos.astype(jnp.float64)
    m = state.mass.astype(jnp.float64)
    if mask is not None:
        m = m * mask
    r = jnp.linalg.norm(pos - center, axis=1)
    order = jnp.argsort(r)
    r_sorted = r[order]
    csum = jnp.cumsum(m[order])
    targets = jnp.asarray(fractions, jnp.float64) * csum[-1]
    idx = jnp.clip(jnp.searchsorted(csum, targets), 0, r.shape[0] - 1)
    # a fully-disrupted selection (mask sums to zero mass) has no
    # meaningful radii: searchsorted(0) would return the innermost
    # particle's radius for every fraction — a tiny, plausible-looking
    # garbage value. NaN signals "no cluster" honestly.
    return jnp.where(csum[-1] > 0, r_sorted[idx], jnp.nan)


def local_density(pos, mass, center, k: int = 6,
                  max_probes: int = 65536, max_sources: int = 65536,
                  chunk: int = 256, r_min: float = 0.0):
    """Casertano & Hut (1985) kth-nearest-neighbour local density estimates.

    For each probe star j: find its k nearest neighbours (self excluded),
    and estimate rho_j = (mass of the k-1 nearest) / (4pi/3 r_k^3) where
    r_k is the distance to the kth — the CH85 unbiased form (the kth
    neighbour defines the volume but its mass is excluded).

    Oversized N: probes and sources are strided down to ``max_probes`` /
    ``max_sources`` (deterministic stride sampling keeps this key-free and
    bit-reproducible); subsampled source masses are scaled by the stride so
    the enclosed-mass estimate stays unbiased in expectation. This bounds
    the O(N_probe * N_source) distance sweep at any N (the macro path runs
    this inside one jitted diagnostics program at N = 8M).

    Distances are computed on CENTRED coordinates (pos - center) in f32 —
    at galactocentric offsets the raw f32 coordinates would eat the
    mantissa (SURVEY.md §7 hard part #1, same reason the kernels centre).

    ``r_min`` floors the kth-neighbour radius: densities on scales below
    the force softening are unresolved by construction (softened forces),
    and without the floor a single hard binary (post-core-collapse) makes
    rho_j of its members explode by orders of magnitude — measured 87.8 →
    3.1e6 across the core bounce in the cc_collapse demo. compute_all
    passes r_min = 2·eps, capping the reported density at the
    resolution-limited value.

    Returns (rho, probe_stride): rho is (ceil(N/probe_stride),) float64,
    aligned with pos[::probe_stride].
    """
    n = pos.shape[0]
    ps = -(-n // max_probes)   # ceil
    ss = -(-n // max_sources)
    probes = (pos - center)[::ps].astype(jnp.float32)
    src = (pos - center)[::ss].astype(jnp.float32)
    msrc = mass[::ss].astype(jnp.float32) * jnp.float32(ss)
    npro = probes.shape[0]
    nsrc = src.shape[0]
    if nsrc <= k:
        return jnp.full((npro,), jnp.nan, jnp.float64), ps
    # r_min may be a traced scalar (compute_all passes 2·eps, a pytree
    # leaf of the jitted-in ForceModel) — keep all ops jnp-level
    rmin2 = jnp.maximum(jnp.asarray(r_min, jnp.float32) ** 2,
                        jnp.float32(1e-30))
    chunk = min(chunk, npro)
    npad = -(-npro // chunk) * chunk
    # padded probes sit at a huge coordinate: their neighbour volumes are
    # enormous, rho ~ 0, and they are sliced off before returning anyway
    probes = jnp.concatenate(
        [probes, jnp.full((npad - npro, 3), 1e30, jnp.float32)], axis=0)

    if k < 2:
        raise ValueError("CH85 local density needs k >= 2")

    def body(pchunk):
        d2 = jnp.sum((pchunk[:, None, :] - src[None, :, :]) ** 2, axis=-1)
        # exclude self-pairs (and exactly-coincident stars — measure zero)
        d2 = jnp.where(d2 <= 0.0, jnp.float32(jnp.inf), d2)
        # kth-nearest distance via k threshold passes: each pass takes the
        # min of the distances strictly above the previous rank's value.
        # O(k·nsrc) elementwise compare/select, replacing lax.top_k over
        # the full source axis (a sort network, measured far slower at
        # the 65536² sweep cap).
        # Tie semantics: exact-duplicate f32 distances collapse to one
        # rank and ALL tied masses count — measure-zero for sampled ICs,
        # and coincident stars are already excluded above.
        thr = jnp.min(d2, axis=1)                      # rank-1 distance²
        thr_prev = thr
        for _ in range(k - 1):
            thr_prev = thr
            thr = jnp.min(jnp.where(d2 <= thr[:, None], jnp.float32(jnp.inf),
                                    d2), axis=1)       # next rank
        # CH85 unbiased form: mass of the k-1 nearest (everything at or
        # inside the rank-(k-1) distance), volume from the kth distance
        mnb = jnp.sum(jnp.where(d2 <= thr_prev[:, None], msrc[None, :], 0.0),
                      axis=1)
        rk2 = jnp.maximum(thr, rmin2).astype(jnp.float64)
        vol = (4.0 * jnp.pi / 3.0) * rk2 ** 1.5
        return mnb.astype(jnp.float64) / vol

    rho = jax.lax.map(body, probes.reshape(-1, chunk, 3)).reshape(-1)
    return rho[:npro], ps


def core_radius_density(state: ParticleState, center=None, k: int = 6,
                        mask=None, max_probes: int = 65536,
                        max_sources: int = 65536, r_min: float = 0.0):
    """Core radius and central density from CH85 local-density weighting.

    r_core = sqrt(sum rho_j^2 |r_j - c|^2 / sum rho_j^2)  (the rho^2-weighted
    rms radius — the NBODY-family convention, so values are comparable to
    what NBODY6-class codes print), and
    rho_core = sum rho_j^2 / sum rho_j  (CH85's rho-weighted mean density).

    ``mask`` (e.g. the bound mask) restricts which stars are *weighted*;
    the density field itself is always estimated from all stars. Returns
    (r_core, rho_core) as f64 scalars; (NaN, NaN) for N <= k+1.
    """
    n = state.pos.shape[0]
    if n <= k + 1:
        nan = jnp.asarray(jnp.nan, jnp.float64)
        return nan, nan
    if center is None:
        center = density_center(state)
    rho, ps = local_density(state.pos, state.mass, center, k=k,
                            max_probes=max_probes, max_sources=max_sources,
                            r_min=r_min)
    r2 = jnp.sum((state.pos[::ps].astype(jnp.float64) - center) ** 2, axis=1)
    if mask is not None:
        rho = rho * mask[::ps]
    w = rho * rho
    wsum = jnp.maximum(jnp.sum(w), 1e-300)
    r_core = jnp.sqrt(jnp.sum(w * r2) / wsum)
    rho_core = wsum / jnp.maximum(jnp.sum(rho), 1e-300)
    # a fully-empty selection (mask sums to zero) has no core
    ok = jnp.sum(rho) > 0
    return (jnp.where(ok, r_core, jnp.nan),
            jnp.where(ok, rho_core, jnp.nan))


def velocity_dispersion_1d(state: ParticleState, mask=None) -> jax.Array:
    """Mass-weighted 1-D velocity dispersion about the (masked) mean
    velocity: sigma_1d = sqrt(sum m |v - v_bar|^2 / (3 sum m)). f64 scalar;
    NaN when the mask selects zero mass."""
    m = state.mass.astype(jnp.float64)
    if mask is not None:
        m = m * mask
    msum = jnp.sum(m)
    vel = state.vel.astype(jnp.float64)
    vb = jnp.sum(vel * m[:, None], axis=0) / jnp.maximum(msum, 1e-300)
    s2 = jnp.sum(m * jnp.sum((vel - vb) ** 2, axis=1))
    return jnp.where(msum > 0,
                     jnp.sqrt(s2 / (3.0 * jnp.maximum(msum, 1e-300))),
                     jnp.nan)


def half_mass_relaxation_time(n_bound, m_bound, r_half, G,
                              gamma: float = 0.11) -> jax.Array:
    """Spitzer–Hart half-mass relaxation time
    t_rh = 0.138 N^{1/2} r_h^{3/2} / ( (G m_bar)^{1/2} ln(gamma N) ),
    evaluated with BOUND N, mean mass and half-mass radius. gamma = 0.11
    (the Giersz & Heggie calibration; 0.4 is Spitzer's original, 0.02 for
    steep mass spectra). Returns NaN when N_bound < 2 or ln(gamma N) <= 0
    (no meaningful relaxation)."""
    nb = jnp.asarray(n_bound, jnp.float64)
    mbar = jnp.asarray(m_bound, jnp.float64) / jnp.maximum(nb, 1.0)
    lnl = jnp.log(jnp.maximum(gamma * nb, 1e-300))
    t = (0.138 * jnp.sqrt(nb) * jnp.asarray(r_half, jnp.float64) ** 1.5
         / jnp.sqrt(jnp.asarray(G, jnp.float64) * jnp.maximum(mbar, 1e-300))
         / jnp.maximum(lnl, 1e-300))
    return jnp.where((nb >= 2) & (lnl > 0), t, jnp.nan)


def bound_mass_energy(state: ParticleState, force: ForceModel,
                      n_iter: int = 8, phi_pair=None):
    """Bound mass via iterated energy cut in the cluster frame.

    A star is bound if 0.5 |v - v_b|^2 + phi_pair(x) < 0, where v_b is the
    mean velocity of currently-bound stars; iterate to a fixpoint (shapes
    fixed, mask-based). Returns (M_bound, N_bound, mask).
    """
    force = force.at_time(state.time)  # no-op for static externals
    m = state.mass.astype(jnp.float64)
    if phi_pair is None:
        _, phi_pair, _ = force.accel_potential(state.pos, state.mass)
    phi_pair = phi_pair.astype(jnp.float64)
    vel = state.vel.astype(jnp.float64)

    def body(_, mask):
        w = m * mask
        vb = jnp.sum(vel * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1e-300)
        ke = 0.5 * jnp.sum((vel - vb) ** 2, axis=1)
        return (ke + phi_pair < 0).astype(jnp.float64)

    mask = jax.lax.fori_loop(0, n_iter, body, jnp.ones_like(m))
    return jnp.sum(m * mask), jnp.sum(mask).astype(jnp.int64), mask


def tidal_radius(m_bound, tidal_coeff, G):
    """King tidal radius r_t = (G M_b / (Ω² − ∂²Φ/∂R²))^{1/3}.

    A non-positive coefficient (cored host potential interiors, where the
    tidal tensor's largest eigenvalue can be more negative than Ω² is
    positive) means NO tidal truncation: r_t = inf, not the ~1e100 of a
    tiny-denominator clamp."""
    lam = jnp.maximum(tidal_coeff, 1e-300)
    r = (G * m_bound / lam) ** (1.0 / 3.0)
    return jnp.where(tidal_coeff > 0, r, jnp.inf)


def bound_mass_tidal(state: ParticleState, force: ForceModel,
                     n_iter: int = 20, center=None, center_vel=None,
                     method: str = "tensor"):
    """Bound mass via the iterative tidal-radius cut (SURVEY.md §2.11).

    Iterates  r_t = (G M_b / λ)^{1/3},  M_b = mass inside r_t  to a
    fixpoint. The tidal coefficient λ comes from one of two methods:

      * ``"tensor"`` (default): λ = λ_max(T) + Ω² with T the full autodiff
        tidal tensor −∂²Φ/∂x∂x at the cluster centre and Ω² = |r×v|²/r⁴
        the instantaneous orbital angular speed (from ``center_vel``, by
        default the mass-weighted mean velocity). Correct for inclined /
        disk-crossing orbits where the vertical tide dominates at crossing
        (VERDICT round-1 W3).
      * ``"midplane"``: the classic in-plane coefficient Ω² − ∂²Φ/∂R²
        evaluated at the centre's cylindrical radius — valid only for
        orbits in the z = 0 plane (kept for comparison/back-compat).

    Returns (M_bound, N_bound, r_t, mask).
    """
    force = force.at_time(state.time)  # no-op for static externals
    if force.external is None:
        m_tot = jnp.sum(state.mass.astype(jnp.float64))
        n = state.mass.shape[0]
        return (m_tot, jnp.asarray(n, jnp.int64), jnp.asarray(jnp.inf),
                jnp.ones((n,), jnp.float64))
    if center is None:
        center = density_center(state)
    pos = state.pos.astype(jnp.float64)
    m = state.mass.astype(jnp.float64)
    d = jnp.linalg.norm(pos - center, axis=1)
    if method == "tensor":
        if center_vel is None:
            vel = state.vel.astype(jnp.float64)
            center_vel = jnp.sum(vel * m[:, None], axis=0) / jnp.sum(m)
        r2 = jnp.sum(center**2)
        omega2 = jnp.sum(jnp.cross(center, center_vel) ** 2) / jnp.maximum(
            r2 * r2, 1e-300)
        lam = force.external.tidal_coefficient_at(center, omega2)
    elif method == "midplane":
        R_gal = jnp.sqrt(center[0] ** 2 + center[1] ** 2)
        lam = force.external.tidal_coefficient(R_gal)
    else:
        raise ValueError(f"unknown tidal method {method!r}")
    m_tot = jnp.sum(m)

    def body(_, m_b):
        r_t = tidal_radius(m_b, lam, force.G)
        return jnp.sum(m * (d < r_t))

    m_b = jax.lax.fori_loop(0, n_iter, body, m_tot)
    r_t = tidal_radius(m_b, lam, force.G)
    mask = (d < r_t).astype(jnp.float64)
    return m_b, jnp.sum(mask).astype(jnp.int64), r_t, mask


def compute_all(state: ParticleState, force: ForceModel,
                fractions=(0.1, 0.25, 0.5, 0.75, 0.9),
                f64_pairwise: bool = False, precomputed_phi=None,
                core: bool = True) -> dict:
    """The full diagnostics row (SURVEY.md §5 metrics list); all scalars
    except lagrangian radii. One jit-able call — except at oversized N,
    where the caller precomputes (phi_pair, phi_ext) with the batched
    chunked kernels outside the jit and passes them via
    ``precomputed_phi`` (every other column is O(N) or O(N·iters)).

    ``core=True`` adds the CH85 core columns (r_core, rho_core) — a second
    bounded O(min(N,65536)²) distance sweep per row (output.core_diag turns
    it off for cost-sensitive runs). sigma_1d / Q_virial / t_rh are O(N)
    and always emitted."""
    force = force.at_time(state.time)  # no-op for static externals
    if precomputed_phi is None:
        # ONE pairwise-potential pass per row, shared by energies() and
        # (isolated clusters) the bound-mass energy cut — a second O(N²)
        # evaluation is never CSE-guaranteed, and under diag_f64 the cut
        # would otherwise use f32 phi while the energies report f64
        if f64_pairwise:
            from oc_nbody_tpu.ops import gravity
            _, phi_pair = gravity.accel_potential(
                state.pos, state.mass, force.eps, force.G,
                compute_dtype=jnp.float64, chunk=512)
            phi_ext = (force.external.phi(state.pos)
                       if force.external is not None
                       else jnp.zeros_like(phi_pair))
        else:
            _, phi_pair, phi_ext = force.accel_potential(state.pos,
                                                         state.mass)
        precomputed_phi = (phi_pair, phi_ext)
    e = energies(state, force, precomputed_phi=precomputed_phi)
    center = density_center(state)
    L = angular_momentum(state)
    if force.external is not None:
        m_b, n_b, r_t, mask = bound_mass_tidal(state, force, center=center,
                                               method="tensor")
    else:
        m_b, n_b, mask = bound_mass_energy(state, force,
                                           phi_pair=precomputed_phi[0])
        r_t = jnp.asarray(jnp.inf)
    rl = lagrangian_radii(state, fractions, center=center, mask=mask)
    out = dict(e)
    out.update({
        "time": state.time,
        "Lx": L[0], "Ly": L[1], "Lz": L[2],
        "L_norm": jnp.linalg.norm(L),
        "M_bound": m_b,
        "N_bound": n_b,
        "r_tidal": r_t,
        "cx": center[0], "cy": center[1], "cz": center[2],
    })
    for f, r in zip(fractions, rl):
        out[f"r_lagr_{int(round(f * 100))}"] = r

    # --- structure / relaxation columns (NBODY-family standards) -------
    # bound-internal virial ratio: KE about the bound COM velocity over
    # |W| with W = half the bound-mass-weighted pairwise potential (the
    # unbound tail contributes to phi but sits far away; documented
    # approximation). Q ~ 0.5 in equilibrium.
    m64 = state.mass.astype(jnp.float64)
    vel64 = state.vel.astype(jnp.float64)
    wb = m64 * mask
    wb_sum = jnp.sum(wb)
    wsum = jnp.maximum(wb_sum, 1e-300)
    vb = jnp.sum(vel64 * wb[:, None], axis=0) / wsum
    ke_b = 0.5 * jnp.sum(wb * jnp.sum((vel64 - vb) ** 2, axis=1))
    w_b = 0.5 * jnp.sum(wb * precomputed_phi[0].astype(jnp.float64))
    # an empty bound selection has no virial state: NaN, not a
    # plausible-looking 0.0 (same convention as lagrangian_radii)
    alive = wb_sum > 0
    out["Q_virial"] = jnp.where(
        alive, ke_b / jnp.maximum(jnp.abs(w_b), 1e-300), jnp.nan)
    # sigma_1d = sqrt(2 KE_b / (3 M_b)) — same sums as the Q block
    out["sigma_1d"] = jnp.where(
        alive, jnp.sqrt(2.0 * ke_b / (3.0 * wsum)), jnp.nan)
    fr = tuple(fractions)
    r_half = (rl[fr.index(0.5)] if 0.5 in fr else
              lagrangian_radii(state, (0.5,), center=center, mask=mask)[0])
    out["t_rh"] = half_mass_relaxation_time(n_b, m_b, r_half, force.G)
    if core:
        # resolution floor 2·eps: sub-softening densities are unresolved
        # (local_density docstring — the hard-binary 1e6x artifact)
        r_c, rho_c = core_radius_density(state, center=center, mask=mask,
                                         r_min=2.0 * force.eps)
        out["r_core"] = r_c
        out["rho_core"] = rho_c
    return out


def jacobi_energy(state: ParticleState, force: ForceModel, omega_p,
                  f64_pairwise: bool = False) -> jax.Array:
    """E_J = E_tot − ω_p·L_z, the Jacobi integral (f64 scalar).

    The conserved quantity for a field rigidly rotating about z at
    pattern speed ``omega_p`` (models/potentials.py Rotating — bars,
    spiral patterns, a perturber on a CircularTrajectory with
    omega = omega_p): in such a field E_tot and L_z each drift
    secularly but E − ω_p L_z does not. This is the rotating-frame
    energy check to use instead of dE/E when the external field has a
    pattern speed."""
    e = energies(state, force, f64_pairwise=f64_pairwise)
    L = angular_momentum(state)
    return e["E_tot"] - jnp.asarray(omega_p, jnp.float64) * L[2]
