"""Chandrasekhar dynamical friction on the cluster's orbit.

The NBODY6tt / PeTar-class capability: a cluster orbiting through a live
host loses orbital energy to the field stars it deflects. The host here is
an analytic potential, so the friction is applied as the standard
Chandrasekhar (1943) drag on the cluster's centre of mass:

    a_df = −4π G² ρ(x) M lnΛ · F(X) · v / v³ ,
    F(X) = erf(X) − 2X e^{−X²}/√π ,   X = v / (√2 σ(x)) ,

evaluated once per force evaluation at the mass-weighted CoM (x, v) and
applied as the SAME acceleration to every star — a rigid drag. A uniform
acceleration adds zero internal perturbation (it cancels in every pairwise
separation), so the cluster's internal dynamics are untouched; only the
orbit decays. This matches how NBODY6tt applies its tidal-tensor-frame
drag. No reference implementation exists to cite (/root/reference is
empty — SURVEY.md §0).

Implementation details:

* ρ(x) comes from the host potential's autodiff Laplacian (Poisson:
  ρ = ∇²Φ/4πG — ``Potential.density``), so ANY host composition gives a
  consistent field density with no per-component formulas. In the DF
  formula 4πG²ρ = G·∇²Φ, so only one explicit G factor appears.
* σ(x): ``sigma > 0`` uses that constant; ``sigma == 0`` uses the local
  isothermal estimate σ = v_circ(r)/√2 of the SPHERICALIZED host (exact
  for a logarithmic halo, the standard approximation elsewhere).
* M is the instantaneous total particle mass (stellar-evolution mass loss
  feeds through automatically). For heavily stripped systems the bound
  mass would be more faithful; using M_tot is conservative and documented.
* Everything is O(1) per force evaluation — one Hessian trace and one
  vcirc autodiff at a single point.

Energy bookkeeping: friction is dissipative by construction — E_tot
decays at dE/dt = M v·a_df < 0. This is physics, not integrator error;
the driver emits the instantaneous drag magnitude (``a_df`` column) and
documents that dE/E is not a conservation check while friction is on.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from oc_nbody_tpu.models.potentials import Potential


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChandrasekharFriction:
    """Rigid Chandrasekhar drag bundled into the ForceModel.

    ``host`` must be the STATIC host potential (time-dependent additions —
    bars, flybys, expelled gas — are perturbations whose phase-space
    density is not what the drag integral is over; scene.py passes the
    base host only).
    """

    host: Potential
    G: jax.Array            # gravitational constant, code units
    ln_lambda: jax.Array    # Coulomb logarithm (user-set; ~ln(M_enc/M_cl))
    sigma: jax.Array        # field dispersion; 0 → vcirc(r)/sqrt(2)

    def accel_df(self, pos, vel, mass):
        """The common drag acceleration (3,) for state arrays (N, 3)."""
        m = mass.astype(jnp.float64)
        m_tot = jnp.sum(m)
        w = m / jnp.maximum(m_tot, 1e-300)
        com = jnp.sum(pos.astype(jnp.float64) * w[:, None], axis=0)
        vcom = jnp.sum(vel.astype(jnp.float64) * w[:, None], axis=0)

        v2 = jnp.sum(vcom * vcom)
        v = jnp.sqrt(jnp.maximum(v2, 1e-300))
        r = jnp.sqrt(jnp.maximum(jnp.sum(com * com), 1e-300))
        sigma = jnp.where(self.sigma > 0, self.sigma,
                          self.host.vcirc(r) / jnp.sqrt(2.0))
        x = v / (jnp.sqrt(2.0) * jnp.maximum(sigma, 1e-300))
        fx = jax.scipy.special.erf(x) \
            - 2.0 * x * jnp.exp(-x * x) / jnp.sqrt(jnp.pi)
        # 4πG²ρ = G·∇²Φ; clamp at 0 (a rigid component substituted into a
        # smooth profile can make the local Laplacian slightly negative)
        g_lap = self.G * jnp.maximum(self.host.laplacian(com), 0.0)
        a = -g_lap * m_tot * self.ln_lambda * fx / jnp.maximum(v2 * v,
                                                               1e-300)
        # v → 0: F(X) ~ (4/3√π)X³ kills the 1/v³ divergence analytically,
        # but the clamped quotient does not — gate explicitly
        return jnp.where(v > 1e-12, a, 0.0) * vcom
