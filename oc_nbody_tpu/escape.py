"""Escape pruning: stop feeling forces FROM far-gone tidal-tail stars.

The NBODY-family "remove escapers" capability (NBODY6 drops stars beyond
~2 r_tide from the force summation entirely), rebuilt for JAX. No
reference implementation exists to cite (/root/reference is empty —
SURVEY.md §0); the capability class is standard for long tidal-stripping
runs, where by late times most stars are unbound tail members that still
cost O(N) pairwise work each while contributing only a diffuse, dynamically
negligible force.

Design (all shapes static inside jit — SURVEY.md §7 "no host branching"):

* Stars beyond ``escape.r_cut`` tidal radii of the density centre become
  TAIL. Only TAIL–TAIL interactions are dropped: cluster stars keep the
  exact force from every star (their dynamics are bitwise the full
  problem's physics), and tail stars feel every cluster star plus the
  external field. The reduced system is a genuine Hamiltonian (H = KE +
  every pair except tail–tail + Φ_ext) — both ends of every retained pair
  feel it, so Newton's third law holds and E drifts only at integrator
  level between re-partitions. (A one-sided variant — tail feels cluster
  but not vice versa — was measured to blow up: the missing reaction
  pumps energy at O(1) per crossing.) Pairwise cost: N·B (all rows ×
  cluster sources) + B·N (cluster rows × all sources) = 2·B·N, vs N².
* Sources are gathered into a power-of-two BUCKET (cluster indices first,
  zero-weight padding): the index VALUES are jit arguments (pytree leaves
  on ForceModel), so re-partitions reuse the compiled program; only a
  bucket-size change recompiles — at most O(log N) programs per run.
* The partition is a HISTORY-FREE function of the current state (density
  centre + iterated tidal radius, neither of which depends on the current
  source set), so a resumed run recomputes exactly the partition the
  uninterrupted run was using — bitwise resume survives
  (tests/unit/test_escape_prune.py).
* Dropping tail–tail terms changes the Hamiltonian at each re-partition;
  the driver measures the jump (same state, old vs new source set) and
  accounts it into the ``E_prune_cum`` ledger, the same convention as the
  stellar-evolution ``E_sev_cum`` — ``E_tot − ledgers`` drifts only by
  integrator error (the ``dE_cons_over_E_int`` column).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from oc_nbody_tpu import diagnostics
from oc_nbody_tpu.state import ParticleState


@jax.jit
def partition_inputs(state: ParticleState, force):
    """(center, r_t) for the pruning cut — both partition-independent:
    the density centre uses positions/masses only, and the iterated tidal
    radius (diagnostics.bound_mass_tidal, tensor method) uses positions,
    masses and the external field. Neither reads the current source set,
    which is what makes resume deterministic."""
    center = diagnostics.density_center(state)
    _, _, r_t, _ = diagnostics.bound_mass_tidal(state, force, center=center,
                                                method="tensor")
    return center, r_t


@jax.jit
def cluster_mask(state: ParticleState, center, r_cut):
    """Boolean (N,): |r − center| <= r_cut (r_cut already includes the
    tidal-radius factor). An infinite r_cut keeps everything — pruning
    silently stays off until a finite tidal radius exists."""
    d = jnp.linalg.norm(state.pos.astype(jnp.float64) - center, axis=1)
    return d <= r_cut


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length()


def build_sources(mask_np: np.ndarray, min_bucket: int):
    """Host-side source-bucket construction from a membership mask.

    Returns (src_idx, src_wgt, n_cluster) as numpy arrays, or None when
    pruning buys nothing (bucket would reach N/2 — the two pruned sweeps
    cost 2·B·N, so B must be under N/2 to win) or no cluster remains.
    Padding repeats the FIRST CLUSTER INDEX with weight 0: zero-mass
    sources contribute exactly nothing to the kernels (w = G·m·inv³ = 0),
    and in the cluster-rows-×-all-sources sweep the padding rows then
    duplicate a real cluster row, so their scattered results are identical
    duplicate writes (order-independent)."""
    n = int(mask_np.shape[0])
    idx = np.nonzero(mask_np)[0].astype(np.int32)
    n_c = int(idx.shape[0])
    if n_c == 0:
        return None
    bucket = max(int(min_bucket), next_pow2(n_c))
    if 2 * bucket >= n:
        return None
    src_idx = np.full(bucket, idx[0], np.int32)
    src_idx[:n_c] = idx
    src_wgt = (np.arange(bucket) < n_c).astype(np.float32)
    return src_idx, src_wgt, n_c
