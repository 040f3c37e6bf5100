"""Multi-device force engine: row-sharded O(N²) with collectives.

Capability parity: SURVEY.md §2.12 / §3.5 — BASELINE.json:11 "force-tile
rows + allreduce". Three source strategies, all expressed with `shard_map`
over a 1-D mesh (XLA hands the collectives to NCCL on GPUs):

  * ``allgather`` — each device owns N/D target rows and all-gathers the
    full source set once per evaluation (one all_gather; best for small/mid
    N where sources fit comfortably in device memory).
  * ``ring``      — sources stay sharded and circulate via `ppermute` around
    the ring while each device accumulates partial forces blockwise —
    structurally identical to ring attention (blockwise accumulation over a
    permuted source shard; SURVEY.md §5 "long-context"). D-1 permutes, no
    replication: the large-N path.
  * ``halfring``  — PAIR-SYMMETRIC ring: each unordered shard pair is
    computed once (the cross-pair kernels return action AND reaction),
    so sources circulate only ⌈(D-1)/2⌉ hops and one ``psum_scatter``
    returns the accumulated reactions to their owners — Newton's-3rd-law
    halving across shards (≈2× less pairwise compute than ``ring`` at large D, for
    (D/2)+1 collectives vs D-1). See ``_halfring_sweep``.

The per-shard compute is the same rows-vs-sources sweep as single-chip
(ops.backend.pair_ops), so sharded == single-device up to f32 summation order (tested in tests/distributed on an 8-device CPU mesh;
SURVEY.md §4.3).

`ShardedForce` duck-types ForceModel (accel / accel_potential / accel_jerk),
so every stepper works unchanged on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from oc_nbody_tpu.models.potentials import Potential
from oc_nbody_tpu.ops import df32, gravity
from oc_nbody_tpu.ops.backend import pair_ops, resolve_backend
from oc_nbody_tpu.parallel.mesh import AXIS


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _two_sum(acc, comp, partial):
    """Kahan step for the ring accumulation across D source shards: the
    cross-shard sum is an f32 accumulation outside the per-shard sweep, so
    compensate it here — O(N/D) extra flops per ring step vs the O(N^2/D^2) kernel.

    The rounded sum passes through ``optimization_barrier``: this loop
    compiles through XLA (shard_map/fori_loop), whose algebraic simplifier
    rewrites the ``(t - acc) - y`` residual to zero inside fused graphs
    (measured — see ops/df32.two_sum), silently degrading the compensation
    to plain f32 summation. The barrier pins t as an opaque f32 value
    (ADVICE round 2, medium; pinned by
    tests/distributed/test_ring_compensation.py)."""
    y = partial - comp
    t = jax.lax.optimization_barrier(acc + y)
    comp = (t - acc) - y
    return t, comp


def _halfring_sweep(ax, d, locals_, circ0, diag_out, cross_fn):
    """Pair-symmetric sharded sweep (mode="halfring"): each unordered
    shard pair is computed ONCE and the reaction delivered back, halving
    the cross-shard pair count vs the one-sided ring (D-1 one-sided evals
    → (D-1)/2 cross-pair evals plus, for even D, two half-size quadrant
    evals).

    Structure (SPMD, device ``idx`` along ``ax``):
      * ``diag_out`` — the pair-symmetric self-interaction of the local
        shard, already computed by the caller.
      * (D-1)//2 hops: the source shard circulates (``ppermute``); each
        hop the cross-pair kernel returns the action on the local rows
        AND the reaction on the circulated shard. Reactions accumulate in
        a (D·S, ...) slot buffer at the owner's slot.
      * even D: after one more hop each unordered pair {A, B = A+D/2} is
        held by BOTH members; to keep shapes uniform across devices each
        member computes two half×half quadrants — the first member
        (idx < D/2) takes (A_f×B_f, A_s×B_s), the second (B_f×A_s,
        B_s×A_f) — covering all four quadrants exactly once.
      * one ``psum_scatter`` returns every reaction slot to its owner
        (reduce-scatter: each device receives the sum of its own slot).

    Cross-shard partial sums are Kahan-compensated with ``_two_sum`` like
    the ring mode (the psum_scatter-internal reduction over ~D/2 partials
    stays plain f32 — unavoidable inside the collective, and small next
    to the per-shard sweeps' own f32 sums).

    ``locals_``/``circ0``: tuples of per-shard arrays (pos[, vel], mass).
    ``cross_fn(rows, circ) -> (outs_on_rows, outs_on_circ)`` with tuples
    of equal length as ``diag_out``. Returns the summed outputs tuple.

    Memory: the reaction slot buffer is (D·S, ...) per device — full-N
    sized, like allgather's source replication (a per-slot ppermute
    return would trade that for D/2 more collectives; not worth it at
    the N/D this engine shards).
    """
    S = circ0[0].shape[0]
    idx = lax.axis_index(ax)
    perm = [(i, (i - 1) % d) for i in range(d)]  # i receives from i+1:
    # after s hops the local circulating copy holds shard (idx + s) % d

    def _idx(start, ndim):
        # axis_index is int32; pad the remaining index slots to match
        # (mixed-width dynamic_slice indices are rejected under x64)
        z = jnp.zeros((), jnp.asarray(start).dtype)
        return (start,) + (z,) * (ndim - 1)

    def slice_r(r, start):
        return lax.dynamic_slice(r, _idx(start, r.ndim), (S,) + r.shape[1:])

    def update_r(r, start, val):
        return lax.dynamic_update_slice(
            r, slice_r(r, start) + val, _idx(start, r.ndim))

    acc = tuple(diag_out)
    if d == 1:
        return acc
    comp = tuple(jnp.zeros_like(a) for a in acc)
    react = tuple(jnp.zeros((d * S,) + a.shape[1:], a.dtype) for a in acc)
    half = (d - 1) // 2
    circ = circ0

    def hop(circ):
        return tuple(lax.ppermute(x, ax, perm) for x in circ)

    def body(s, carry):
        acc, comp, react, circ = carry
        circ = hop(circ)
        outsA, outsB = cross_fn(locals_, circ)
        slot = ((idx + s) % d) * S
        pairs = [_two_sum(a, c, oa) for a, c, oa in zip(acc, comp, outsA)]
        acc = tuple(p[0] for p in pairs)
        comp = tuple(p[1] for p in pairs)
        react = tuple(update_r(r, slot, ob)
                      for r, ob in zip(react, outsB))
        return acc, comp, react, circ

    if half >= 1:
        acc, comp, react, circ = lax.fori_loop(
            1, half + 1, body, (acc, comp, react, circ))

    if d % 2 == 0:
        circ = hop(circ)  # now holds shard (idx + d/2) % d
        h = S // 2
        first = idx < (d // 2)
        s1 = jnp.where(first, 0, h)
        slot = ((idx + d // 2) % d) * S
        rows1 = tuple(x[:h] for x in locals_)
        rows2 = tuple(x[h:] for x in locals_)

        def csl(x, start):
            return lax.dynamic_slice(x, _idx(start, x.ndim),
                                     (h,) + x.shape[1:])

        o1A, o1B = cross_fn(rows1, tuple(csl(x, s1) for x in circ))
        o2A, o2B = cross_fn(rows2, tuple(csl(x, h - s1) for x in circ))
        pairs = [_two_sum(a, c, jnp.concatenate([a1, a2], axis=0))
                 for a, c, a1, a2 in zip(acc, comp, o1A, o2A)]
        acc = tuple(p[0] for p in pairs)
        comp = tuple(p[1] for p in pairs)

        def half_buf(o1, o2):
            buf = jnp.zeros((S,) + o1.shape[1:], o1.dtype)
            buf = lax.dynamic_update_slice(buf, o1, _idx(s1, o1.ndim))
            return lax.dynamic_update_slice(buf, o2, _idx(h - s1, o2.ndim))

        react = tuple(update_r(r, slot, half_buf(o1, o2))
                      for r, o1, o2 in zip(react, o1B, o2B))

    recv = tuple(lax.psum_scatter(r, ax, scatter_dimension=0, tiled=True)
                 for r in react)
    return tuple(_two_sum(a, c, rv)[0]
                 for a, c, rv in zip(acc, comp, recv))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedForce:
    """Row-sharded force engine over a 1-D device mesh."""

    eps: jax.Array
    G: jax.Array
    external: Optional[Potential] = None
    mesh: Mesh = dataclasses.field(default=None, metadata=dict(static=True))
    mode: str = dataclasses.field(default="allgather", metadata=dict(static=True))
    backend: str = dataclasses.field(default="auto", metadata=dict(static=True))
    chunk: int = dataclasses.field(default=1024, metadata=dict(static=True))
    # run the Pallas kernels through the interpreter (tests on the CPU)
    interpret: bool = dataclasses.field(default=False,
                                        metadata=dict(static=True))
    # pairwise arithmetic tier on the mesh: "f32" | "extended" (hi/lo
    # planes split ONCE under the global centring, then sharded — see
    # _split_global). The df32 tier stays single-chip (make_sharded_force
    # rejects it with the routing rationale).
    precision: str = dataclasses.field(default="f32", metadata=dict(static=True))
    # Chandrasekhar dynamical friction (round-4: [friction] composes with
    # the mesh): the rigid CoM drag is an O(1) add evaluated on the
    # GLOBAL state OUTSIDE shard_map — GSPMD reduces the mass-weighted
    # CoM across shards like any other replicated reduction, so no
    # per-mode wiring exists; same zero-jerk contract as ForceModel.
    friction: Optional[object] = None
    # ---- escape pruning on the mesh (round-4: the bucket gather composes
    # with row sharding). Same contract as ForceModel: sources become the
    # gathered cluster bucket, only tail–tail interactions are dropped.
    # The SHARDED cost story is better than the collectives suggest:
    # sweep 1 (local rows × replicated bucket) needs NO collective at all
    # — the full-source allgather/ring disappears — and sweep 2 (bucket ×
    # local source shard) reduces one (B, ·) psum. Per-chip pairwise work
    # drops from N²/D to 2·B·N/D. All three are pytree leaves (jit
    # arguments; only a bucket-size change recompiles).
    src_idx: Optional[jax.Array] = None
    src_wgt: Optional[jax.Array] = None
    src_mask: Optional[jax.Array] = None

    @property
    def pruned(self) -> bool:
        return self.src_idx is not None

    def with_sources(self, src_idx, src_wgt, src_mask) -> "ShardedForce":
        """Return a copy using the pruned source set (escape pruning).
        f32 and extended tiers (round-5: the hi/lo pruned planes split
        rows AND bucket under one global frame — the bucket mean — the
        same invariant the sharded extended tier keeps); df32 routes to
        emulated f64 and stays single-chip, as everywhere on the mesh."""
        if self.precision not in ("f32", "extended"):
            raise ValueError(
                "escape pruning on a mesh supports the f32 and extended "
                f"tiers only (got precision={self.precision!r})")
        return dataclasses.replace(self, src_idx=src_idx, src_wgt=src_wgt,
                                   src_mask=src_mask)

    def at_time(self, t):
        """Bind the external field's evaluation time (same contract as
        ForceModel.at_time): no-op for static externals, a Bound wrapper
        carrying ``t`` as a pytree leaf for time-dependent ones. The
        bound external evaluates on each shard's LOCAL rows inside
        shard_map — O(rows), no collectives involved."""
        if self.external is None:
            return self
        ext = self.external.at(t)
        return self if ext is self.external else dataclasses.replace(
            self, external=ext)

    # ---- rows-vs-sources kernel dispatch ------------------------------
    def _rows_kernel(self):
        """The resolved backend's pairwise functions (ops.backend)."""
        return pair_ops(self.backend, self.interpret)

    def _hilo_kernels(self):
        """Module providing the *_x_hilo extended-tier entry points (the
        XLA-compiled ops.df32, oracle-tested in tests/distributed)."""
        return df32

    def _split_global(self, arr):
        """Centred (hi, lo) f32 split of an f64 (N, 3) array. One GLOBAL
        centring before shard_map: every chip's hi plane must share one
        frame, or the hi/lo invariant breaks as source slabs circulate
        the ring (each shard would need the others' centres)."""
        return df32.df_from_f64(arr - jnp.mean(arr, axis=0))

    def _gm32(self, mass):
        return (jnp.asarray(self.G, jnp.float64)
                * jnp.asarray(mass, jnp.float64)).astype(jnp.float32)

    @property
    def axis(self) -> str:
        return self.mesh.axis_names[0] if self.mesh is not None else AXIS

    def _pad(self, arrs, n):
        d = self.mesh.devices.size
        n_pad = _round_up(n, d * 8)
        if n_pad == n:
            return arrs
        out = []
        for a in arrs:
            width = ((0, n_pad - n),) + ((0, 0),) * (a.ndim - 1)
            out.append(jnp.pad(a, width))
        return out

    # ---- extended tier (hi/lo planes through the same collectives) ----
    def _accel_extended(self, pos, mass):
        m = self._hilo_kernels()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        n = pos.shape[0]
        hi, lo = self._split_global(pos)
        hi_p, lo_p, gm_p = self._pad([hi, lo, self._gm32(mass)], n)
        ax = self.axis

        def shard_fn(hi_l, lo_l, gm_l):
            if self.mode == "halfring":
                # diag one-sided (no hilo sym-self entry point; the cross
                # sweeps dominate at D >= 4), crosses pair-symmetric
                diag = (m.accel_rows_x_hilo(hi_l, lo_l, hi_l, lo_l, gm_l,
                                            eps32),)

                def cross(rows, circ):
                    aA, aB = m.accel_cross_pair_x_hilo(
                        rows[0], rows[1], circ[0], circ[1],
                        rows[2], circ[2], eps32)
                    return (aA,), (aB,)

                return _halfring_sweep(
                    ax, self.mesh.devices.size, (hi_l, lo_l, gm_l),
                    (hi_l, lo_l, gm_l), diag, cross)[0]
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, comp, sh, sl, sg = carry
                    da = m.accel_rows_x_hilo(hi_l, lo_l, sh, sl, sg, eps32)
                    acc, comp = _two_sum(acc, comp, da)
                    sh = lax.ppermute(sh, ax, perm)
                    sl = lax.ppermute(sl, ax, perm)
                    sg = lax.ppermute(sg, ax, perm)
                    return acc, comp, sh, sl, sg

                z = jnp.zeros_like(hi_l)
                acc, _, _, _, _ = lax.fori_loop(
                    0, d, body, (z, z, hi_l, lo_l, gm_l))
                return acc
            sh = lax.all_gather(hi_l, ax, tiled=True)
            sl = lax.all_gather(lo_l, ax, tiled=True)
            sg = lax.all_gather(gm_l, ax, tiled=True)
            return m.accel_rows_x_hilo(hi_l, lo_l, sh, sl, sg, eps32)

        out = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax), P(ax), P(ax)), out_specs=P(ax),
            check_vma=False,
        )(hi_p, lo_p, gm_p)
        acc = out[:n].astype(pos.dtype)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def _accel_potential_extended(self, pos, mass):
        m = self._hilo_kernels()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        G32 = jnp.asarray(self.G, jnp.float32)
        n = pos.shape[0]
        hi, lo = self._split_global(pos)
        mass32 = jnp.asarray(mass, jnp.float32)
        hi_p, lo_p, gm_p = self._pad([hi, lo, self._gm32(mass)], n)
        ax = self.axis

        def shard_fn(hi_l, lo_l, gm_l):
            if self.mode == "halfring":
                # diag one-sided: phi keeps the rows==sources self-term
                # contract, and the outer self_phi addition corrects it
                # (cross phi has no self term — disjoint sets)
                diag = m.accel_potential_rows_x_hilo(hi_l, lo_l, hi_l, lo_l,
                                                     gm_l, eps32)

                def cross(rows, circ):
                    aA, pA, aB, pB = m.accel_potential_cross_pair_x_hilo(
                        rows[0], rows[1], circ[0], circ[1],
                        rows[2], circ[2], eps32)
                    return (aA, pA), (aB, pB)

                return _halfring_sweep(
                    ax, self.mesh.devices.size, (hi_l, lo_l, gm_l),
                    (hi_l, lo_l, gm_l), diag, cross)
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, phi, ca, cp, sh, sl, sg = carry
                    da, dp = m.accel_potential_rows_x_hilo(
                        hi_l, lo_l, sh, sl, sg, eps32)
                    acc, ca = _two_sum(acc, ca, da)
                    phi, cp = _two_sum(phi, cp, dp)
                    sh = lax.ppermute(sh, ax, perm)
                    sl = lax.ppermute(sl, ax, perm)
                    sg = lax.ppermute(sg, ax, perm)
                    return acc, phi, ca, cp, sh, sl, sg

                z = jnp.zeros_like(hi_l)
                zp = jnp.zeros_like(hi_l[:, 0])
                acc, phi, _, _, _, _, _ = lax.fori_loop(
                    0, d, body, (z, zp, z, zp, hi_l, lo_l, gm_l))
                return acc, phi
            sh = lax.all_gather(hi_l, ax, tiled=True)
            sl = lax.all_gather(lo_l, ax, tiled=True)
            sg = lax.all_gather(gm_l, ax, tiled=True)
            return m.accel_potential_rows_x_hilo(hi_l, lo_l, sh, sl, sg,
                                                 eps32)

        acc, phi = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax), P(ax), P(ax)), out_specs=(P(ax), P(ax)),
            check_vma=False,
        )(hi_p, lo_p, gm_p)
        acc = acc[:n].astype(pos.dtype)
        # tier phi includes the softened self term -G m/eps when eps > 0;
        # self_phi (+G m/eps) cancels it — the oracle contract
        phi = (phi[:n] + gravity.self_phi(mass32, eps32, G32)).astype(pos.dtype)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
            phi_ext = self.external.phi(pos)
        else:
            phi_ext = jnp.zeros_like(phi)
        return acc, phi, phi_ext

    def _accel_jerk_extended(self, pos, vel, mass):
        m = self._hilo_kernels()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        n = pos.shape[0]
        hi, lo = self._split_global(pos)
        vhi, vlo = self._split_global(vel)
        hi_p, lo_p, vhi_p, vlo_p, gm_p = self._pad(
            [hi, lo, vhi, vlo, self._gm32(mass)], n)
        ax = self.axis

        def shard_fn(hi_l, lo_l, vhi_l, vlo_l, gm_l):
            if self.mode == "halfring":
                diag = m.accel_jerk_rows_x_hilo(
                    hi_l, lo_l, vhi_l, vlo_l,
                    hi_l, lo_l, vhi_l, vlo_l, gm_l, eps32)

                def cross(rows, circ):
                    aA, jA, aB, jB = m.accel_jerk_cross_pair_x_hilo(
                        rows[0], rows[1], rows[2], rows[3],
                        circ[0], circ[1], circ[2], circ[3],
                        rows[4], circ[4], eps32)
                    return (aA, jA), (aB, jB)

                return _halfring_sweep(
                    ax, self.mesh.devices.size,
                    (hi_l, lo_l, vhi_l, vlo_l, gm_l),
                    (hi_l, lo_l, vhi_l, vlo_l, gm_l), diag, cross)
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, jerk, ca, cj, sh, sl, svh, svl, sg = carry
                    da, dj = m.accel_jerk_rows_x_hilo(
                        hi_l, lo_l, vhi_l, vlo_l, sh, sl, svh, svl, sg,
                        eps32)
                    acc, ca = _two_sum(acc, ca, da)
                    jerk, cj = _two_sum(jerk, cj, dj)
                    sh = lax.ppermute(sh, ax, perm)
                    sl = lax.ppermute(sl, ax, perm)
                    svh = lax.ppermute(svh, ax, perm)
                    svl = lax.ppermute(svl, ax, perm)
                    sg = lax.ppermute(sg, ax, perm)
                    return acc, jerk, ca, cj, sh, sl, svh, svl, sg

                z = jnp.zeros_like(hi_l)
                acc, jerk, _, _, _, _, _, _, _ = lax.fori_loop(
                    0, d, body,
                    (z, z, z, z, hi_l, lo_l, vhi_l, vlo_l, gm_l))
                return acc, jerk
            sh = lax.all_gather(hi_l, ax, tiled=True)
            sl = lax.all_gather(lo_l, ax, tiled=True)
            svh = lax.all_gather(vhi_l, ax, tiled=True)
            svl = lax.all_gather(vlo_l, ax, tiled=True)
            sg = lax.all_gather(gm_l, ax, tiled=True)
            return m.accel_jerk_rows_x_hilo(hi_l, lo_l, vhi_l, vlo_l,
                                            sh, sl, svh, svl, sg, eps32)

        acc, jerk = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax),) * 5, out_specs=(P(ax), P(ax)),
            check_vma=False,
        )(hi_p, lo_p, vhi_p, vlo_p, gm_p)
        acc = acc[:n].astype(pos.dtype)
        jerk = jerk[:n].astype(pos.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk

    # ---- pruned (rows-vs-sources) sharded evaluation -------------------
    def _pruned_eval(self, pos, mass, vel=None, want: str = "accel"):
        """The pruned two-sweep evaluation on the mesh (same Hamiltonian
        contract as ForceModel's pruned dispatch — only tail–tail dropped):

          sweep 1 — LOCAL rows × replicated bucket (no collective)
          sweep 2 — bucket × the local source shard, one psum

        then the replicated sweep-2 results scatter into each shard's own
        rows (src_idx ∈ [off, off+S) with positive weight; others route to
        a discarded overflow slot). Per chip: (N/D)·B + B·(N/D) pairs and
        ONE (B, ·)-sized collective — the full-source allgather/ring is
        gone entirely, which is the sharded pruning win.

        Tiers (round-5): f32, and extended — hi/lo planes of ALL rows and
        the bucket split under ONE global frame (the bucket mean, f64),
        the same invariant the sharded extended tier keeps; both tiers
        share this skeleton, only the kernel builders differ."""
        eps32 = jnp.asarray(self.eps, jnp.float32)
        n = pos.shape[0]
        ax = self.axis
        idx32 = self.src_idx.astype(jnp.int32)
        live = self.src_wgt > 0
        sp = pos[self.src_idx]
        sm = mass[self.src_idx] * self.src_wgt.astype(mass.dtype)
        center = jnp.mean(sp.astype(jnp.float64), axis=0)

        if self.precision == "extended":
            m = self._hilo_kernels()

            def split(a, c):
                return df32.df_from_f64(a.astype(jnp.float64) - c)

            rhi, rlo = split(pos, center)
            bhi, blo = split(sp, center)
            gm_b = self._gm32(sm)
            gm_all = self._gm32(mass)
            args = [rhi, rlo]
            if vel is not None:
                sv = vel[self.src_idx]
                vcenter = jnp.mean(sv.astype(jnp.float64), axis=0)
                vrhi, vrlo = split(vel, vcenter)
                vbhi, vblo = split(sv, vcenter)
                args += [vrhi, vrlo]
            args.append(gm_all)

            def f1(loc):
                if want == "accel":
                    return (m.accel_rows_x_hilo(loc[0], loc[1], bhi, blo,
                                                gm_b, eps32),)
                if want == "phi":
                    return m.accel_potential_rows_x_hilo(
                        loc[0], loc[1], bhi, blo, gm_b, eps32)
                return m.accel_jerk_rows_x_hilo(
                    loc[0], loc[1], loc[2], loc[3], bhi, blo, vbhi, vblo,
                    gm_b, eps32)

            def f2(loc):
                if want == "accel":
                    return (m.accel_rows_x_hilo(bhi, blo, loc[0], loc[1],
                                                loc[-1], eps32),)
                if want == "phi":
                    return m.accel_potential_rows_x_hilo(
                        bhi, blo, loc[0], loc[1], loc[-1], eps32)
                return m.accel_jerk_rows_x_hilo(
                    bhi, blo, vbhi, vblo, loc[0], loc[1], loc[2], loc[3],
                    loc[-1], eps32)

            # gm = G·m, so self_phi with G = 1 gives exactly +G m/eps
            phi_corr = gravity.self_phi(gm_all[self.src_idx], eps32,
                                        jnp.float32(1.0))
        else:
            k = self._rows_kernel()
            G32 = jnp.asarray(self.G, jnp.float32)
            sm32 = sm.astype(jnp.float32)
            bucket_c = (sp.astype(jnp.float64) - center).astype(jnp.float32)
            rows_c = (pos.astype(jnp.float64) - center).astype(jnp.float32)
            amass_c = jnp.asarray(mass, jnp.float32)
            args = [rows_c]
            if vel is not None:
                vcenter = jnp.mean(vel[self.src_idx].astype(jnp.float64),
                                   axis=0)
                vrows_c = (vel.astype(jnp.float64)
                           - vcenter).astype(jnp.float32)
                vbucket_c = (vel[self.src_idx].astype(jnp.float64)
                             - vcenter).astype(jnp.float32)
                args.append(vrows_c)
            args.append(amass_c)

            def f1(loc):
                if want == "accel":
                    return (k.accel_rows(loc[0], bucket_c, sm32, eps32,
                                         G32, self.chunk),)
                if want == "phi":
                    return k.accel_potential_rows(loc[0], bucket_c, sm32,
                                                  eps32, G32, self.chunk)
                return k.accel_jerk_rows(loc[0], loc[1], bucket_c,
                                         vbucket_c, sm32, eps32, G32,
                                         self.chunk)

            def f2(loc):
                if want == "accel":
                    return (k.accel_rows(bucket_c, loc[0], loc[-1], eps32,
                                         G32, self.chunk),)
                if want == "phi":
                    return k.accel_potential_rows(bucket_c, loc[0],
                                                  loc[-1], eps32, G32,
                                                  self.chunk)
                return k.accel_jerk_rows(bucket_c, vbucket_c, loc[0],
                                         loc[1], loc[-1], eps32, G32,
                                         self.chunk)

            phi_corr = gravity.self_phi(amass_c[self.src_idx], eps32, G32)

        padded = self._pad(args, n)

        def shard_fn(*local):
            S = local[0].shape[0]
            off = lax.axis_index(ax) * S
            t1 = f1(local)
            t2 = f2(local)
            cl = tuple(lax.psum(p, ax) for p in t2)
            in_shard = (idx32 >= off) & (idx32 < off + S) & live
            idx_l = jnp.where(in_shard, idx32 - off, S)   # S = overflow
            outs = []
            for tail, c in zip(t1, cl):
                pad = jnp.zeros((S + 1,) + tail.shape[1:], tail.dtype)
                pad = pad.at[:S].set(tail)
                outs.append(pad.at[idx_l].set(c)[:S])
            return tuple(outs)

        n_out = {"accel": 1, "phi": 2, "jerk": 2}[want]
        out = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax),) * len(padded),
            out_specs=(P(ax),) * n_out if n_out > 1 else P(ax),
            check_vma=False,
        )(*padded)
        out = out if isinstance(out, tuple) else (out,)
        out = [o[:n].astype(pos.dtype) for o in out]
        if want == "phi":
            # sweep-2 rows are sources of their own shard's source set:
            # cancel the softened self term (live bucket entries only —
            # padding duplicates a real index with weight 0)
            out[1] = out[1].at[self.src_idx].add(
                jnp.where(live, phi_corr, 0.0).astype(out[1].dtype))
        return tuple(out)

    # ---- public API (mirrors ForceModel) ------------------------------
    def _add_df(self, acc, pos, vel, mass):
        """Add the dynamical-friction drag (ForceModel's contract: vel is
        required when friction is configured; zero jerk term)."""
        if self.friction is None:
            return acc
        if vel is None:
            raise ValueError(
                "this ShardedForce carries dynamical friction: "
                "accel() needs the velocities (vel=...)")
        return acc + self.friction.accel_df(pos, vel, mass).astype(
            acc.dtype)

    def accel(self, pos, mass, vel=None):
        # ``vel``: the KDK/Yoshida steppers pass their kick-point velocity
        # for velocity-dependent terms (the dynamical-friction drag here)
        if self.pruned:
            (acc,) = self._pruned_eval(pos, mass, want="accel")
            if self.external is not None:
                acc = acc + self.external.accel(pos)
            return self._add_df(acc, pos, vel, mass)
        if self.precision == "extended":
            return self._add_df(self._accel_extended(pos, mass),
                                pos, vel, mass)
        k = self._rows_kernel()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        G32 = jnp.asarray(self.G, jnp.float32)
        n = pos.shape[0]
        pos_c, mass_c = gravity.prepare_f32(pos, mass)
        pos_p, mass_p = self._pad([pos_c, mass_c], n)
        ax = self.axis

        def shard_fn(pos_l, mass_l):
            if self.mode == "halfring":
                # pair-symmetric: each unordered shard pair computed once
                # (diag via the backend's one-sided sweep, crosses via the
                # jnp cross-pair sweeps, reactions returned by
                # psum_scatter)
                diag = (k.accel(pos_l, mass_l, eps32, G32, chunk=self.chunk),)

                def cross(rows, circ):
                    aA, aB = gravity.accel_cross_pair(rows[0], circ[0],
                                                      rows[1], circ[1],
                                                      eps32, G32,
                                                      chunk=self.chunk)
                    return (aA,), (aB,)

                return _halfring_sweep(
                    ax, self.mesh.devices.size, (pos_l, mass_l),
                    (pos_l, mass_l), diag, cross)[0]
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, comp, sp, sm = carry
                    da = k.accel_rows(pos_l, sp, sm, eps32, G32, self.chunk)
                    acc, comp = _two_sum(acc, comp, da)
                    sp = lax.ppermute(sp, ax, perm)
                    sm = lax.ppermute(sm, ax, perm)
                    return acc, comp, sp, sm

                acc0 = jnp.zeros_like(pos_l)
                acc, _, _, _ = lax.fori_loop(
                    0, d, body, (acc0, acc0, pos_l, mass_l))
                return acc
            src_pos = lax.all_gather(pos_l, ax, tiled=True)
            src_mass = lax.all_gather(mass_l, ax, tiled=True)
            return k.accel_rows(pos_l, src_pos, src_mass, eps32, G32, self.chunk)

        out = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax), P(ax)), out_specs=P(ax),
            check_vma=False,
        )(pos_p, mass_p)
        acc = out[:n].astype(pos.dtype)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return self._add_df(acc, pos, vel, mass)

    def accel_potential(self, pos, mass):
        if self.pruned:
            acc, phi = self._pruned_eval(pos, mass, want="phi")
            if self.external is not None:
                acc = acc + self.external.accel(pos)
                phi_ext = self.external.phi(pos)
            else:
                phi_ext = jnp.zeros_like(phi)
            return acc, phi, phi_ext
        if self.precision == "extended":
            return self._accel_potential_extended(pos, mass)
        k = self._rows_kernel()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        G32 = jnp.asarray(self.G, jnp.float32)
        n = pos.shape[0]
        pos_c, mass_c = gravity.prepare_f32(pos, mass)
        pos_p, mass_p = self._pad([pos_c, mass_c], n)
        ax = self.axis

        def shard_fn(pos_l, mass_l):
            if self.mode == "halfring":
                # diag phi comes out of the public dispatcher ALREADY
                # self-term corrected; cross phi has no self term (disjoint
                # sets) — so the outer self_phi addition is skipped for
                # this mode (see below)
                diag = k.accel_potential(pos_l, mass_l, eps32, G32,
                                         chunk=self.chunk)

                def cross(rows, circ):
                    aA, pA, aB, pB = gravity.accel_potential_cross_pair(
                        rows[0], circ[0], rows[1], circ[1], eps32, G32,
                        chunk=self.chunk)
                    return (aA, pA), (aB, pB)

                return _halfring_sweep(
                    ax, self.mesh.devices.size, (pos_l, mass_l),
                    (pos_l, mass_l), diag, cross)
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, phi, ca, cp, sp, sm = carry
                    da, dp = k.accel_potential_rows(pos_l, sp, sm, eps32, G32,
                                                    self.chunk)
                    acc, ca = _two_sum(acc, ca, da)
                    phi, cp = _two_sum(phi, cp, dp)
                    sp = lax.ppermute(sp, ax, perm)
                    sm = lax.ppermute(sm, ax, perm)
                    return acc, phi, ca, cp, sp, sm

                acc0 = jnp.zeros_like(pos_l)
                phi0 = jnp.zeros_like(pos_l[:, 0])  # inherits the shard vma
                acc, phi, _, _, _, _ = lax.fori_loop(
                    0, d, body, (acc0, phi0, acc0, phi0, pos_l, mass_l))
                return acc, phi
            src_pos = lax.all_gather(pos_l, ax, tiled=True)
            src_mass = lax.all_gather(mass_l, ax, tiled=True)
            return k.accel_potential_rows(pos_l, src_pos, src_mass, eps32, G32,
                                          self.chunk)

        acc, phi = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax), P(ax)), out_specs=(P(ax), P(ax)),
            check_vma=False,
        )(pos_p, mass_p)
        acc = acc[:n].astype(pos.dtype)
        if self.mode == "halfring":
            # the halfring diag used the self-corrected public dispatcher
            phi = phi[:n].astype(pos.dtype)
        else:
            phi = (phi[:n] + gravity.self_phi(mass_c, eps32, G32)).astype(pos.dtype)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
            phi_ext = self.external.phi(pos)
        else:
            phi_ext = jnp.zeros_like(phi)
        return acc, phi, phi_ext

    def accel_jerk(self, pos, vel, mass):
        if self.pruned:
            acc, jerk = self._pruned_eval(pos, mass, vel=vel, want="jerk")
            if self.external is not None:
                a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
                acc = acc + a_ext
                jerk = jerk + da_ext
            return self._add_df(acc, pos, vel, mass), jerk
        if self.precision == "extended":
            acc, jerk = self._accel_jerk_extended(pos, vel, mass)
            return self._add_df(acc, pos, vel, mass), jerk
        k = self._rows_kernel()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        G32 = jnp.asarray(self.G, jnp.float32)
        n = pos.shape[0]
        pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
        pos_p, mass_p, vel_p = self._pad([pos_c, mass_c, vel_c], n)
        ax = self.axis

        def shard_fn(pos_l, vel_l, mass_l):
            if self.mode == "halfring":
                diag = k.accel_jerk(pos_l, vel_l, mass_l, eps32, G32,
                                    chunk=self.chunk)

                def cross(rows, circ):
                    aA, jA, aB, jB = gravity.accel_jerk_cross_pair(
                        rows[0], rows[1], circ[0], circ[1],
                        rows[2], circ[2], eps32, G32, chunk=self.chunk)
                    return (aA, jA), (aB, jB)

                return _halfring_sweep(
                    ax, self.mesh.devices.size, (pos_l, vel_l, mass_l),
                    (pos_l, vel_l, mass_l), diag, cross)
            if self.mode == "ring":
                d = self.mesh.devices.size
                perm = [(i, (i + 1) % d) for i in range(d)]

                def body(_, carry):
                    acc, jerk, ca, cj, sp, sv, sm = carry
                    da, dj = k.accel_jerk_rows(pos_l, vel_l, sp, sv, sm,
                                               eps32, G32, self.chunk)
                    acc, ca = _two_sum(acc, ca, da)
                    jerk, cj = _two_sum(jerk, cj, dj)
                    sp = lax.ppermute(sp, ax, perm)
                    sv = lax.ppermute(sv, ax, perm)
                    sm = lax.ppermute(sm, ax, perm)
                    return acc, jerk, ca, cj, sp, sv, sm

                z = jnp.zeros_like(pos_l)
                acc, jerk, _, _, _, _, _ = lax.fori_loop(
                    0, d, body, (z, z, z, z, pos_l, vel_l, mass_l))
                return acc, jerk
            src_pos = lax.all_gather(pos_l, ax, tiled=True)
            src_vel = lax.all_gather(vel_l, ax, tiled=True)
            src_mass = lax.all_gather(mass_l, ax, tiled=True)
            return k.accel_jerk_rows(pos_l, vel_l, src_pos, src_vel, src_mass,
                                     eps32, G32, self.chunk)

        acc, jerk = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ax), P(ax), P(ax)), out_specs=(P(ax), P(ax)),
            check_vma=False,
        )(pos_p, vel_p, mass_p)
        acc = acc[:n].astype(pos.dtype)
        jerk = jerk[:n].astype(pos.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return self._add_df(acc, pos, vel, mass), jerk

    def accel_jerk_on_rows(self, pos_rows, vel_rows, src_pos, src_vel,
                           src_mass, rows_mask=None):
        """Block-timestep active-row evaluation on the mesh: the (small) row
        set is replicated, sources stay row-sharded, and each chip's partial
        (accel, jerk) is psum-reduced — the BASELINE.json:11
        allreduce applied to the active subset (SURVEY.md §2 EP analog).

        ``rows_mask`` (round-5: escape pruning composes with the sharded
        block path) selects per row between two evaluations, the same
        Hamiltonian contract as ForceModel._accel_jerk_on_rows: cluster
        rows × ALL sources (the sharded psum eval below) and tail rows ×
        the replicated cluster bucket (a LOCAL rows×B eval — B is small,
        so it is computed replicated on every chip with no collective).
        The lax.switch on the rows' actual membership pays only what this
        micro-step needs: all-cluster steps (deep rungs) cost exactly the
        unpruned sharded eval, all-tail steps cost rows×B with ZERO
        collectives — the sharded block-pruning win — and only mixed
        steps (block-grid sync boundaries) pay both. The switch predicate
        is replicated (derived from the replicated rows_mask), so every
        device takes the same branch and the collectives inside stay
        SPMD-consistent."""
        if rows_mask is not None and self.pruned:
            sp = src_pos[self.src_idx]
            sv = src_vel[self.src_idx]
            sm = (jnp.asarray(src_mass)[self.src_idx]
                  * self.src_wgt.astype(jnp.asarray(src_mass).dtype))
            base = dataclasses.replace(self, src_idx=None, src_wgt=None,
                                       src_mask=None)

            def eval_cluster(_):
                return base.accel_jerk_on_rows(pos_rows, vel_rows,
                                               src_pos, src_vel, src_mass)

            def eval_tail(_):
                return self._rows_vs_bucket_jerk(pos_rows, vel_rows,
                                                 sp, sv, sm,
                                                 src_pos, src_vel,
                                                 jnp.asarray(src_mass))

            def eval_mixed(_):
                a_cl, j_cl = eval_cluster(None)
                a_tail, j_tail = eval_tail(None)
                mb = (rows_mask >= 0.5)[:, None]
                return (jnp.where(mb, a_cl, a_tail),
                        jnp.where(mb, j_cl, j_tail))

            any_tail = jnp.any(rows_mask == 0.0)
            any_cl = jnp.any(rows_mask == 1.0)
            which = jnp.where(any_tail & any_cl, 2,
                              jnp.where(any_tail, 1, 0)).astype(jnp.int32)
            return jax.lax.switch(
                which, [eval_cluster, eval_tail, eval_mixed], 0)
        if rows_mask is not None:
            raise ValueError("rows_mask given but this ShardedForce "
                             "carries no pruned source set")
        if self.precision == "extended":
            acc, jerk = self._accel_jerk_on_rows_extended(
                pos_rows, vel_rows, src_pos, src_vel, src_mass)
            if self.friction is not None:
                acc = acc + self.friction.accel_df(
                    src_pos, src_vel, jnp.asarray(src_mass)).astype(
                        acc.dtype)
            return acc, jerk
        k = self._rows_kernel()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        G32 = jnp.asarray(self.G, jnp.float32)
        center = jnp.mean(src_pos, axis=0)
        vcenter = jnp.mean(src_vel, axis=0)
        rows_c = (pos_rows - center).astype(jnp.float32)
        vrows_c = (vel_rows - vcenter).astype(jnp.float32)
        src_c = (src_pos - center).astype(jnp.float32)
        svel_c = (src_vel - vcenter).astype(jnp.float32)
        mass_c = jnp.asarray(src_mass, jnp.float32)
        ns = src_c.shape[0]
        src_p, svel_p, mass_p = self._pad([src_c, svel_c, mass_c], ns)
        ax = self.axis

        def shard_fn(rows, vrows, sp, sv, sm):
            da, dj = k.accel_jerk_rows(rows, vrows, sp, sv, sm, eps32, G32,
                                       self.chunk)
            return lax.psum(da, ax), lax.psum(dj, ax)

        acc, jerk = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(), P(), P(ax), P(ax), P(ax)),
            out_specs=(P(), P()),
            check_vma=False,
        )(rows_c, vrows_c, src_p, svel_p, mass_p)
        acc = acc.astype(pos_rows.dtype)
        jerk = jerk.astype(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
            acc = acc + a_ext
            jerk = jerk + da_ext
        if self.friction is not None:
            # the rigid CoM drag from the FULL (predicted) source state,
            # added to every active row — ForceModel.accel_jerk_on_rows's
            # exact contract (uniform => cancels in pairwise separations)
            acc = acc + self.friction.accel_df(
                src_pos, src_vel, jnp.asarray(src_mass)).astype(acc.dtype)
        return acc, jerk

    def _rows_vs_bucket_jerk(self, pos_rows, vel_rows, sp, sv, sm,
                             src_pos, src_vel, src_mass):
        """Tail-rows (accel, jerk): rows × the gathered cluster bucket,
        computed REPLICATED on every chip (B is small — a collective
        would cost more than the redundant flops). External field and
        friction are added exactly like the sharded cluster eval so the
        pruned switch's branches stay interchangeable per row."""
        eps32 = jnp.asarray(self.eps, jnp.float32)
        if self.precision == "extended":
            m = self._hilo_kernels()
            center = jnp.mean(sp.astype(jnp.float64), axis=0)
            vcenter = jnp.mean(sv.astype(jnp.float64), axis=0)

            def split(a, c):
                return df32.df_from_f64(a.astype(jnp.float64) - c)

            rhi, rlo = split(pos_rows, center)
            vrhi, vrlo = split(vel_rows, vcenter)
            bhi, blo = split(sp, center)
            vbhi, vblo = split(sv, vcenter)
            acc, jerk = m.accel_jerk_rows_x_hilo(
                rhi, rlo, vrhi, vrlo, bhi, blo, vbhi, vblo,
                self._gm32(sm), eps32)
        else:
            k = self._rows_kernel()
            G32 = jnp.asarray(self.G, jnp.float32)
            center = jnp.mean(sp, axis=0)
            vcenter = jnp.mean(sv, axis=0)
            acc, jerk = k.accel_jerk_rows(
                (pos_rows - center).astype(jnp.float32),
                (vel_rows - vcenter).astype(jnp.float32),
                (sp - center).astype(jnp.float32),
                (sv - vcenter).astype(jnp.float32),
                sm.astype(jnp.float32), eps32, G32, self.chunk)
        acc = acc.astype(pos_rows.dtype)
        jerk = jerk.astype(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
            acc = acc + a_ext
            jerk = jerk + da_ext
        if self.friction is not None:
            acc = acc + self.friction.accel_df(
                src_pos, src_vel, src_mass).astype(acc.dtype)
        return acc, jerk

    def _accel_jerk_on_rows_extended(self, pos_rows, vel_rows, src_pos,
                                     src_vel, src_mass):
        """Extended-tier active-row evaluation on the mesh: rows and
        sources split under the SOURCE-mean centring (both hi planes in
        one frame), rows replicated, source planes row-sharded, per-chip
        partials psum-reduced."""
        m = self._hilo_kernels()
        eps32 = jnp.asarray(self.eps, jnp.float32)
        center = jnp.mean(src_pos, axis=0)
        vcenter = jnp.mean(src_vel, axis=0)

        def split(a, c):
            return df32.df_from_f64(a - c)

        rhi, rlo = split(pos_rows, center)
        rvhi, rvlo = split(vel_rows, vcenter)
        shi, slo = split(src_pos, center)
        svhi, svlo = split(src_vel, vcenter)
        ns = src_pos.shape[0]
        shi_p, slo_p, svhi_p, svlo_p, gm_p = self._pad(
            [shi, slo, svhi, svlo, self._gm32(src_mass)], ns)
        ax = self.axis

        def shard_fn(rh, rl, vh, vl, sh, sl, svh, svl, sg):
            da, dj = m.accel_jerk_rows_x_hilo(rh, rl, vh, vl, sh, sl,
                                              svh, svl, sg, eps32)
            return lax.psum(da, ax), lax.psum(dj, ax)

        acc, jerk = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P(ax), P(ax), P(ax), P(ax), P(ax)),
            out_specs=(P(), P()),
            check_vma=False,
        )(rhi, rlo, rvhi, rvlo, shi_p, slo_p, svhi_p, svlo_p, gm_p)
        acc = acc.astype(pos_rows.dtype)
        jerk = jerk.astype(pos_rows.dtype)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos_rows, vel_rows)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk


def make_sharded_force(eps, G=1.0, external=None, mesh: Mesh = None,
                       mode: str = "allgather", backend: str = "auto",
                       chunk: int = 1024, precision: str = "f32",
                       friction=None, interpret: bool = False) -> ShardedForce:
    if mode == "rdma":
        raise ValueError(
            "mesh mode 'rdma' was removed: its in-kernel remote copies have "
            "no GPU form. Use mode='ring', the same ring over collectives")
    if mode not in ("allgather", "ring", "halfring"):
        raise ValueError(f"unknown sharded-force mode {mode!r}")
    if precision not in ("f32", "extended"):
        # df32 stays single-chip: on the mesh the honest routing already
        # sends it to emulated f64 (slower than extended for ~no accuracy
        # need the extended tier doesn't meet) — reject explicitly rather
        # than silently degrade (ADVICE round-2 pattern)
        raise ValueError(
            f"sharded force precision {precision!r} not supported; use "
            "'f32' or 'extended' (df32 is single-chip only)")
    resolve_backend(backend, interpret=interpret)  # unknown names raise
    if mesh is None:
        from oc_nbody_tpu.parallel.mesh import make_mesh
        mesh = make_mesh()
    return ShardedForce(
        eps=jnp.asarray(eps, jnp.float64),
        G=jnp.asarray(G, jnp.float64),
        external=external, mesh=mesh, mode=mode, backend=backend, chunk=chunk,
        precision=precision, friction=friction, interpret=interpret,
    )
