"""oc_nbody_tpu — open-cluster direct N-body engine for the GPU.

A JAX/XLA/Pallas framework with the capabilities of the
``gusbeane/oc_nbody`` reference (see SURVEY.md; the reference tree was empty
at survey time, so capability parity is pinned to BASELINE.json's north-star
spec rather than to file:line citations).

Design rules (SURVEY.md §7):
  * all simulation state is a pytree of arrays, resident in device memory;
  * steppers are pure functions ``carry -> carry`` under ``jit``;
  * the host touches data only at IC / diagnostic / snapshot boundaries;
  * every Pallas kernel has a pure-jnp reference twin used by the tests.

Precision policy (SURVEY.md §7 "hard parts" #1): particle positions and
velocities are stored in float64 (cheap at O(N)); the O(N^2) pairwise force
kernel runs in float32 on cluster-centred offsets. This keeps |dE/E| per
crossing time under the 1e-6 target while the hot loop stays in f32.
"""

import jax as _jax

# Must happen before any f64 array is created anywhere in the package.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from oc_nbody_tpu.state import ParticleState, make_state  # noqa: E402,F401
from oc_nbody_tpu.utils.units import UnitSystem  # noqa: E402,F401
