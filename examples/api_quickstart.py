#!/usr/bin/env python
"""Programmatic (non-CLI) use of oc_nbody_tpu, end to end.

The CLI driver (``python -m oc_nbody_tpu run cfg.toml``) is a thin layer
over the same objects used here: build a unit system + force model,
sample an IC, place it on a galactic orbit, construct a stepper, advance
under jit, compute diagnostics. This script runs anywhere (CPU jnp
backend included); on a GPU the same code runs the Pallas kernels.

Usage: python examples/api_quickstart.py [N]
"""
import sys

import jax
import jax.numpy as jnp

from oc_nbody_tpu.diagnostics import compute_all
from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.integrators.leapfrog import LeapfrogKDK
from oc_nbody_tpu.models.plummer import plummer
from oc_nbody_tpu.models.potentials import milky_way
from oc_nbody_tpu.utils.units import UnitSystem


def main(argv=None):
    n = int((argv if argv is not None else sys.argv[1:] or [2048])[0])

    # 1. Units: Hénon N-body units tied to a physical cluster scale
    #    (G = 1; one code mass = the cluster, one code length = its scale).
    us = UnitSystem.henon(mass_msun=4e4, length_pc=4.0)
    print(f"time unit = {us.time_myr:.3f} Myr, G = {us.G:.3g}")

    # 2. External Milky Way field (scaled into code units) + force model
    #    (backend auto: Pallas kernels on a GPU, blocked jnp elsewhere).
    mw = milky_way(us.G, mass_scale=1.0 / us.mass_msun,
                   length_scale=1.0 / us.length_pc)
    force = make_force_model(eps=0.05, G=us.G, external=mw)

    # 3. IC: virialised Plummer sphere — here with net rotation (the
    #    Lynden-Bell sign-flip: equilibrium preserved, Lz aligned) —
    #    on a circular orbit at R0 = 8 kpc. Other IC layers compose the
    #    same way: models/binaries.add_binaries (primordial pairs),
    #    models/stellar_evolution.make_stellar_evolution (death tables
    #    the driver applies at diagnostics boundaries).
    from oc_nbody_tpu.models.rotation import add_rotation
    state = plummer(n, jax.random.PRNGKey(0))
    state = add_rotation(state, jax.random.PRNGKey(1), fraction=0.5)
    R0 = us.to_code(8000.0, "length")
    state = state.shifted(
        dpos=jnp.array([R0, 0.0, 0.0]),
        dvel=jnp.array([0.0, float(mw.vcirc(R0)), 0.0]))

    # 4. Stepper: KDK leapfrog; one jitted superstep of k steps.
    stepper = LeapfrogKDK(force=force, dt=1.0 / 256)
    carry = stepper.init(state)
    advance = jax.jit(stepper.advance, static_argnums=1)

    d0 = compute_all(carry.state, force)
    print(f"t=0      E={float(d0['E_tot']):+.6e}  "
          f"M_bound={float(d0['M_bound']):.3f}")

    d = d0
    for _ in range(4):
        carry = advance(carry, 64)
        d = compute_all(carry.state, force)
        dE = (d["E_tot"] - d0["E_tot"]) / abs(d0["E_int"])
        print(f"t={float(carry.state.time):.4f} "
              f"E={float(d['E_tot']):+.6e}  dE/E_int={float(dE):+.2e}  "
              f"M_bound={float(d['M_bound']):.3f}")

    r_half = float(d["r_lagr_50"])  # 50% Lagrangian radius
    print(f"final r_half = {r_half:.3f} (code) = "
          f"{us.to_physical(r_half, 'length'):.2f} pc")
    return 0


if __name__ == "__main__":
    sys.exit(main())
