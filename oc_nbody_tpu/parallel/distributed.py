"""Multi-host (multi-process) initialisation.

Capability parity: SURVEY.md §5 "distributed communication backend" —
JAX's built-in multi-controller runtime in place of MPI: each host runs the
same program, `jax.distributed.initialize()` wires the hosts together, and
the SAME `shard_map`/collective code used on one host's GPUs then spans
hosts transparently (XLA hands the collectives to NCCL). No code elsewhere
in this package is host-count-aware.

Without a cluster manager nothing tells JAX of the cluster: pass
``coordinator_address`` ("host:port"), ``num_processes`` and ``process_id``.
The multi-device logic it feeds is covered by tests/distributed on an
emulated mesh (SURVEY.md §4.3).
"""
from __future__ import annotations

from typing import Optional

import jax


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the multi-host runtime (no-op if already initialised).

    With no arguments JAX autodetects only under a cluster manager it
    knows; otherwise pass ``coordinator_address="host:port"``,
    ``num_processes`` and ``process_id`` (the jax.distributed contract).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh_devices():
    """All devices across all hosts, in process order (mesh construction
    for multi-host runs: pass to parallel.mesh via jax.devices())."""
    return jax.devices()
