"""Net rotation for spherical ICs — the Lynden-Bell sign-flip trick.

Capability parity with McLuster-class IC generators (the reference tree
is empty — SURVEY.md §0; this is the standard way those tools spin up a
King/Plummer model without leaving equilibrium): for a fraction
``eta`` of stars whose azimuthal velocity about the z-axis is negative,
flip the sign of that azimuthal component,

    v  ->  v − 2·(v·phi_hat)·phi_hat ,   phi_hat = (−y, x, 0)/R .

The flip preserves |v| (so every particle's energy in any spherical or
axisymmetric-about-z potential is unchanged), preserves L² (vphi² is
unchanged), and maps Lz -> |Lz| — so a distribution function f(E, L²)
remains a stationary solution ("Lynden-Bell demon"), now with net
angular momentum about z. ``eta = 1`` gives maximal rotation for the
given model (every star orbits prograde); intermediate values align a
random subset.

Device-friendly: one O(N) masked elementwise update, no host branching.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["add_rotation"]


def add_rotation(state, key, fraction: float):
    """Return ``state`` with a fraction of retrograde stars made prograde.

    ``fraction`` in [0, 1]: probability that a retrograde star (Lz < 0)
    has its azimuthal velocity sign flipped. 0 is a no-op; 1 aligns all.
    Deterministic in ``key``; positions and masses are untouched.
    """
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"ic.rotation must be in [0, 1], got {fraction}")
    if fraction == 0.0:
        return state
    x, y = state.pos[:, 0], state.pos[:, 1]
    r2 = x * x + y * y
    # on-axis stars have no azimuthal direction; guard the normalisation
    # and leave them untouched (flip term is zero there anyway)
    inv_r = jnp.where(r2 > 0, 1.0 / jnp.sqrt(jnp.maximum(r2, 1e-300)), 0.0)
    phix, phiy = -y * inv_r, x * inv_r          # phi_hat in the x-y plane
    vphi = state.vel[:, 0] * phix + state.vel[:, 1] * phiy
    sel = jnp.logical_and(
        vphi < 0,
        jax.random.uniform(key, (state.n,), jnp.float32) < fraction)
    dv = jnp.where(sel, -2.0 * vphi, 0.0)
    vel = state.vel.at[:, 0].add(dv * phix).at[:, 1].add(dv * phiy)
    return state.replace(vel=vel)
