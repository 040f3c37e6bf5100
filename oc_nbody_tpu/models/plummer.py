"""Plummer-sphere initial conditions, sampled on device with jax.random.

Capability parity: SURVEY.md §2.5 — the reference's Plummer generator
(BASELINE.json:7 "Plummer sphere N=1024"). Sampling follows the classic
Aarseth–Hénon–Wielen (1974) inverse-CDF + rejection recipe:

  * radius: M(<r) uniform in (0,1)  =>  r = a (u^{-2/3} - 1)^{-1/2}
  * speed:  v = q v_esc(r) with q drawn by rejection from g(q) = q^2 (1-q^2)^{7/2}
  * isotropic directions for both.

Everything is jnp + jax.random: deterministic given the PRNG key,
vectorised, and runs on any backend identically.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from oc_nbody_tpu.state import ParticleState, make_state

# Plummer scale radius in Hénon (virial) units: r_vir = 16/(3 pi) a
_A_HENON = 3.0 * jnp.pi / 16.0
# Half-mass radius in units of a: r_h = a / sqrt(2^{2/3} - 1) ≈ 1.30477 a
HALF_MASS_RADIUS_OVER_A = 1.0 / (2.0 ** (2.0 / 3.0) - 1.0) ** 0.5


def _isotropic(key, n, dtype):
    """n random unit vectors, (n, 3)."""
    kz, kphi = jax.random.split(key)
    z = jax.random.uniform(kz, (n,), dtype, -1.0, 1.0)
    phi = jax.random.uniform(kphi, (n,), dtype, 0.0, 2.0 * jnp.pi)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=1)


def _sample_q(key, n, dtype, n_rounds: int = 24):
    """Rejection-sample q in (0,1) from g(q) = q^2 (1-q^2)^{7/2}.

    Fixed-shape batched rejection: each round draws a full batch of
    candidates and keeps the first acceptance per slot — branch-free and
    jit-friendly (acceptance rate ≈ 0.098 per draw; 24 rounds leave a
    miss probability < 1e-24 per slot, and misses fall back to the mode).
    """
    gmax = 0.0935  # > max_q g(q) = (2/9)(7/9)^{7/2} ≈ 0.09222
    q_mode = jnp.asarray(jnp.sqrt(2.0 / 9.0) * jnp.sqrt(2.0), dtype)  # argmax ≈ 0.667

    def round_fn(carry, k):
        q, accepted = carry
        kq, ku = jax.random.split(k)
        qc = jax.random.uniform(kq, q.shape, dtype)
        uc = jax.random.uniform(ku, q.shape, dtype, 0.0, gmax)
        ok = uc < qc * qc * (1.0 - qc * qc) ** 3.5
        take = ok & (~accepted)
        return (jnp.where(take, qc, q), accepted | ok), None

    keys = jax.random.split(key, n_rounds)
    (q, accepted), _ = jax.lax.scan(
        round_fn, (jnp.full((n,), q_mode, dtype), jnp.zeros((n,), bool)), keys
    )
    return q


def plummer(
    n: int,
    key: jax.Array,
    a: float | None = None,
    total_mass: float = 1.0,
    G: float = 1.0,
    masses=None,
    cutoff_mass_fraction: float = 0.999,
    dtype=jnp.float64,
) -> ParticleState:
    """Sample an N-particle Plummer sphere in virial equilibrium.

    Args:
      n: number of particles.
      key: PRNG key (determinism: same key -> bitwise-same IC).
      a: Plummer scale radius; default 3π/16 gives Hénon units
         (virial radius 1, E = -1/4) when total_mass = G = 1.
      total_mass: cluster mass in code units.
      G: gravitational constant in code units.
      masses: optional (n,) per-particle masses (e.g. from an IMF); they are
        rescaled to sum to ``total_mass``. Default: equal masses.
      cutoff_mass_fraction: truncate the outermost mass fraction so a finite
        sample has no huge-radius outliers (standard practice).
      dtype: state dtype for pos/vel.
    """
    if a is None:
        a = float(_A_HENON)
    kr, kdir, kq, kvdir = jax.random.split(key, 4)

    u = jax.random.uniform(kr, (n,), dtype, 0.0, cutoff_mass_fraction)
    r = a / jnp.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _isotropic(kdir, n, dtype)

    # escape speed at r: v_esc^2 = 2 G M / sqrt(r^2 + a^2)
    vesc = jnp.sqrt(2.0 * G * total_mass) * (r * r + a * a) ** (-0.25)
    q = _sample_q(kq, n, dtype)
    vel = (q * vesc)[:, None] * _isotropic(kvdir, n, dtype)

    if masses is None:
        mass = jnp.full((n,), total_mass / n, jnp.float32)
    else:
        masses = jnp.asarray(masses, jnp.float64)
        mass = (masses / jnp.sum(masses) * total_mass).astype(jnp.float32)

    state = make_state(pos, vel, mass, state_dtype=dtype)
    # remove the (small, finite-N) centre-of-mass drift
    return state.replace(
        pos=state.pos - state.com(), vel=state.vel - state.com_vel()
    )
