"""The one place that chooses the pairwise backend.

``auto`` means the Pallas (Triton) kernels of ``ops.triton_gravity`` on a
GPU and the XLA-compiled jnp path of ``ops.gravity`` elsewhere. An explicit
``pallas`` on a platform that cannot compile the kernels raises, unless the
caller asks for the Pallas interpreter (``interpret=True``, tests only).
"""
from __future__ import annotations

import functools
import types

import jax

from oc_nbody_tpu.ops import gravity

BACKENDS = ("auto", "jnp", "pallas")


def resolve_backend(backend: str = "auto", platform: str | None = None,
                    interpret: bool = False) -> str:
    """``"jnp"`` or ``"pallas"`` for ``backend`` on ``platform`` (default:
    JAX's default backend)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown force backend {backend!r}; "
                         f"choose one of {BACKENDS}")
    platform = platform or jax.default_backend()
    if backend == "auto":
        return "pallas" if platform == "gpu" else "jnp"
    if backend == "pallas" and platform != "gpu" and not interpret:
        raise ValueError(
            f"backend='pallas' compiles only for the GPU (platform is "
            f"{platform!r}); use backend='jnp' or 'auto'")
    return backend


_OPS = ("accel", "accel_potential", "accel_jerk", "accel_rows",
        "accel_potential_rows", "accel_jerk_rows")


@functools.lru_cache(maxsize=None)
def _ops(resolved: str, interpret: bool):
    if resolved == "jnp":
        return types.SimpleNamespace(**{k: getattr(gravity, k)
                                        for k in _OPS})
    from oc_nbody_tpu.ops import triton_gravity
    return types.SimpleNamespace(**{
        k: functools.partial(getattr(triton_gravity, k), interpret=interpret)
        for k in _OPS})


def pair_ops(backend: str = "auto", interpret: bool = False):
    """The pairwise functions of the resolved backend, all with
    ``ops.gravity``'s signatures: ``accel``, ``accel_potential``,
    ``accel_jerk`` (single-chip, centre and cast inside) and the
    rows-vs-sources ``accel_rows``, ``accel_potential_rows``,
    ``accel_jerk_rows``."""
    return _ops(resolve_backend(backend, interpret=interpret), interpret)
