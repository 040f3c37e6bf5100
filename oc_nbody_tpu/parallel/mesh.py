"""Device mesh construction for multi-device runs.

Capability parity: SURVEY.md §2.12 — rebuild-only component (force-tile
rows sharded across a device mesh, BASELINE.json:11). Every GPU of a host
reaches every other at the same NVLink rate, so the mesh follows the
algorithm alone. A 1-D mesh is the
right shape for direct N-body: the N×N interaction matrix is sharded by
target rows (the DP analog), with sources either all-gathered (small N) or
ring-permuted (large N; the ring/flash-attention analog — SURVEY.md §5
"long-context").
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` visible devices (all if 0/None)."""
    devs = jax.devices()
    if n_devices in (None, 0):
        n = len(devs)
    else:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        n = n_devices
    return Mesh(np.array(devs[:n]), (axis_name,))
