"""Benchmark: pairwise accel interactions/s at N=65536 on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "device"}: the f32
accel sweep of the backend ``auto`` resolves to (ops.backend), timed as a
dependent chain. Needs a GPU; exits non-zero without one.
"""
from __future__ import annotations

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

from oc_nbody_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = 65536
EPS = 1.0 / 256
REPEATS = 10


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (platform {dev.platform!r})")

    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.models.plummer import plummer
    from oc_nbody_tpu.ops.backend import resolve_backend

    state = plummer(N, jax.random.PRNGKey(0))
    backend = resolve_backend("auto")
    force = make_force_model(eps=EPS, backend=backend)

    # dependent chain: each eval's input depends on the previous output, so
    # the runtime cannot overlap or memoize repeated identical dispatches
    @jax.jit
    def chain(pos, k):
        def body(_, p):
            a = force.accel(p, state.mass)
            return p + 1e-300 * a  # not foldable, keeps the chain dependent
        return jax.lax.fori_loop(0, k, body, pos)

    chain(state.pos, 1).block_until_ready()  # compile + warm-up
    t0 = time.perf_counter()
    chain(state.pos, 1).block_until_ready()
    t1 = time.perf_counter()
    chain(state.pos, 1 + REPEATS).block_until_ready()
    t2 = time.perf_counter()
    dt = ((t2 - t1) - (t1 - t0)) / REPEATS  # slope: per-eval

    print(json.dumps({
        "metric": "pairwise_interactions_per_sec",
        "value": N * N / dt,
        "unit": "interactions/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "backend": backend},
    }))


if __name__ == "__main__":
    main()
