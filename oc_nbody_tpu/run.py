"""Run driver: config -> simulate -> outputs.

Capability parity: SURVEY.md §3.1 — the top-level simulation loop. Host and
device touch only at three boundaries: IC upload, diagnostics scalars every
``diag_every``, snapshot downloads every ``snap_every`` (BASELINE.json:5
"HBM-resident particle state"). The hot loop is the jitted
``stepper.advance_to`` (a lax.while_loop of steps, one device call per
output interval).

Failure handling (SURVEY.md §5): diagnostics are checked with isfinite; on a
non-finite total energy the driver writes an emergency snapshot and raises.
Snapshots double as checkpoints; ``run(config, resume=True)`` restores the
latest valid snapshot (with integrator aux, so the continuation is
bit-identical — tested in tests/io).
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Optional

import jax
import numpy as np

from oc_nbody_tpu import diagnostics as diag_mod
from oc_nbody_tpu.config import SimConfig
from oc_nbody_tpu.io.snapshot import SnapshotWriter, latest_snapshot, read_snapshot
from oc_nbody_tpu.scene import build_scene, make_stepper


@dataclasses.dataclass
class RunResult:
    state: object
    carry: object
    diagnostics: dict          # column -> np.ndarray time series
    out_dir: str
    wall_time_s: float
    n_steps: int
    wall_per_myr: float = float("nan")  # BASELINE.json:5 "wall-clock/Myr"


def run(cfg: SimConfig, resume: bool = False,
        progress: Optional[callable] = None,
        profile_dir: Optional[str] = None) -> RunResult:
    """Run a simulation; with ``profile_dir`` set, every superstep dispatch
    is captured into a Perfetto/XProf trace there (SURVEY.md §5
    tracing/profiling; ``--profile DIR`` on the CLI)."""
    if profile_dir is not None:
        from oc_nbody_tpu.utils.profiling import trace
        with trace(profile_dir):
            return _run(cfg, resume=resume, progress=progress)
    return _run(cfg, resume=resume, progress=progress)


def _diag_extra_fn(cfg: SimConfig, scene):
    """Physics-aware extra diagnostic columns for time-dependent fields
    (jit-safe; returns None when neither applies):

    * ``E_J`` = E_tot − Ω_p·L_z — the Jacobi integral, the conserved
      quantity when the external field rotates rigidly at the configured
      bar pattern speed (diagnostics.jacobi_energy rationale; constant
      only once the growth ramp has ended).
    * ``d_pert`` — distance from the cluster density centre to the
      configured perturber (locates closest approach in flyby runs).
    """
    import jax.numpy as jnp

    from oc_nbody_tpu.models import potentials as pot_mod

    ext = scene.force.external
    comps = (ext.components if isinstance(ext, pot_mod.Composite)
             else [ext]) if ext is not None else []
    omega = None
    traj = None
    for c in comps:
        # read Ω_p off the wrapper actually integrated (possibly inside a
        # growth ramp) rather than re-deriving from the config — one unit
        # conversion, in scene._build_bar only
        base = c.base if isinstance(c, pot_mod.Ramped) else c
        if isinstance(base, pot_mod.Rotating) and omega is None:
            omega = base.omega_p
        if isinstance(c, pot_mod.MovingCenter) and traj is None:
            traj = c.trajectory
    if omega is None and traj is None:
        return None

    def add(row, state):
        if omega is not None:
            row["E_J"] = row["E_tot"] - omega * row["Lz"]
        if traj is not None:
            cen = jnp.stack([row["cx"], row["cy"], row["cz"]])
            row["d_pert"] = jnp.linalg.norm(traj(state.time) - cen)
        return row

    return add


def _merge_reinit_carry(new_carry, old_carry, keep_steps: bool):
    """Merge a freshly-init'd stepper carry with the pre-boundary one.

    Run counters always survive. ``keep_steps=True`` (escape-pruning
    re-partitions) preserves the timestep state outright (block dt_i
    rungs / hermite shared dt): dropping tail–tail forces barely perturbs
    valid step sizes, and re-deriving them from the conservative eta_init
    startup rule at every boundary was measured to triple the block
    drift. ``keep_steps=False`` (SEV mass-change boundaries) takes the
    elementwise MIN of the re-derived startup steps and the pre-jump
    ones: attribution measured (bench/flagship_attrib.py, round 4) the
    flagship's +9.0e-4/interval ledger jump is the post-death transient
    integrating on startup rungs one level coarser than the running
    Aarseth rungs (halving eta_init drops it to 7.6e-6; eta, kicks,
    diag_f64 all move nothing). The old rungs carry the a2/a3 information
    the first-order startup rule lacks; min() keeps the fresh rule's
    response to kicked/perturbed stars and can only refine elsewhere
    (block dt_i are power-of-two int64 rung lengths, so the min is a
    valid rung)."""
    c = new_carry
    names = ("n_steps", "n_active_sum") + (
        ("dt_i", "dt") if keep_steps else ())
    keep = {f.name: getattr(old_carry, f.name)
            for f in dataclasses.fields(c) if f.name in names}
    if not keep_steps:
        fields = {f.name for f in dataclasses.fields(c)}
        for nm in ("dt_i", "dt"):
            if nm in fields and hasattr(old_carry, nm):
                keep[nm] = jax.numpy.minimum(getattr(c, nm),
                                             getattr(old_carry, nm))
    return dataclasses.replace(c, **keep) if keep else c


def _run(cfg: SimConfig, resume: bool = False,
         progress: Optional[callable] = None) -> RunResult:
    scene = build_scene(cfg)
    stepper, kind = make_stepper(cfg, scene.force)
    host_stepping = bool(getattr(stepper, "host_stepping", False))

    # ---- escape pruning (oc_nbody_tpu/escape.py) ------------------------
    # Tail stars beyond escape.r_cut tidal radii stop being pairwise
    # SOURCES; the partition is a history-free function of the current
    # state (resume-deterministic) and the source arrays are jit ARGUMENTS
    # (only a bucket-size change recompiles).
    pruning = bool(cfg.escape.prune)
    _prune = {"src": None, "e_cum": 0.0, "mask": None,
              "n_cluster": scene.state.pos.shape[0], "warned_inf": False}
    if pruning:
        from oc_nbody_tpu import escape as escape_mod
        # sharded force (round-4: pruning composes with the mesh —
        # ShardedForce.with_sources; round-5: both tiers and the block
        # active-row eval are pruned-wired, so no mesh-specific refusals
        # remain — the tier check below applies to both force kinds)
        if scene.force.external is None:
            raise ValueError("escape.prune needs an external potential "
                             "(the cut is in tidal radii)")
        if scene.force.precision not in ("f32", "extended"):
            raise ValueError("escape.prune supports the f32 and extended "
                             f"tiers only (got {scene.force.precision!r})")
        if cfg.output.diag_f64:
            raise ValueError("escape.prune is inconsistent with "
                             "output.diag_f64 (the f64 diagnostics "
                             "potential sums over ALL pairs)")

    def _force_with(src):
        return scene.force if src is None else scene.force.with_sources(*src)

    def cur_force():
        return _force_with(_prune["src"])

    def _repartition(state) -> bool:
        """Recompute the partition from the CURRENT state; returns True
        when the source set (membership or bucket) changed."""
        center, r_t = escape_mod.partition_inputs(state, scene.force)
        r_cut = float(jax.device_get(r_t)) * cfg.escape.r_cut
        mask_np = None
        new = None
        n_c = state.pos.shape[0]
        if not np.isfinite(r_cut) and not _prune["warned_inf"]:
            # tensor-method tidal radius needs a positive tidal coefficient
            # (Omega^2 - d^2Phi/dR^2 > 0): inside a rising rotation curve or
            # during a deep perturber/bar passage it goes non-positive ->
            # r_t = inf and pruning silently never activates. Say so ONCE
            # (VERDICT round-3 W6: nothing told the user why their [escape]
            # config did nothing).
            _prune["warned_inf"] = True
            print("escape.prune: tidal radius is infinite at this boundary "
                  "(non-stripping potential here: tidal coefficient "
                  "Omega^2 - d^2Phi/dR^2 <= 0) - pruning stays inactive "
                  "until a finite tidal radius exists", flush=True)
        if np.isfinite(r_cut):
            mask_np = np.asarray(jax.device_get(
                escape_mod.cluster_mask(state, center, r_cut)))
            # report the real membership even while the bucket is
            # unbuildable (n_c > N/4, pruning not yet worth it) — the
            # N_cluster column is how a user watches the partition approach
            # activation
            n_c = int(mask_np.sum())
            built = escape_mod.build_sources(mask_np, cfg.escape.min_bucket)
            if built is None:
                mask_np = None            # bucket would reach N/2: off
            else:
                idx, wgt, n_c = built
                new = (jax.device_put(idx), jax.device_put(wgt),
                       jax.device_put(mask_np.astype(np.float64)))
        old_mask = _prune["mask"]
        changed = not (
            (old_mask is None and mask_np is None)
            or (old_mask is not None and mask_np is not None
                and old_mask.shape == mask_np.shape
                and _prune["src"][0].shape == new[0].shape
                and np.array_equal(old_mask, mask_np)))
        _prune["mask"] = mask_np
        _prune["src"] = new
        _prune["n_cluster"] = int(n_c)
        return changed
    # physical-time fields (Myr) override the code-unit ones. The converted
    # values live on a local copy: mutating cfg.output in place made a
    # second run(cfg) — or reading cfg.output.t_end afterwards — silently
    # see converted values (VERDICT round-2 W4).
    out = cfg.output
    _myr = {}
    if out.t_end_myr is not None:
        _myr["t_end"] = out.t_end_myr / scene.units.time_myr
    if out.diag_every_myr is not None:
        _myr["diag_every"] = out.diag_every_myr / scene.units.time_myr
    if out.snap_every_myr is not None:
        _myr["snap_every"] = out.snap_every_myr / scene.units.time_myr
    if _myr:
        out = dataclasses.replace(out, **_myr)
    writer = SnapshotWriter(out.out_dir, units=scene.units,
                            config_json=cfg.to_json())

    t0 = float(scene.state.time)
    carry = None
    snap_index = 0
    restored_attrs = {}
    rng_key = scene.rng_key  # persisted in every snapshot (SURVEY.md §4.4)
    if resume:
        path = latest_snapshot(out.out_dir)
        if path is None and writer.has_outputs():
            # resume was requested but there is nothing to resume FROM, yet
            # the directory holds outputs (e.g. diagnostics from a run that
            # crashed before its first snapshot). Falling through to the
            # fresh-run path would reset_outputs() and destroy them
            # (ADVICE round-2, low) — refuse instead.
            raise FileNotFoundError(
                f"--resume requested but no snapshot exists in "
                f"{out.out_dir!r} (it does hold other outputs; delete them "
                f"or drop --resume to start fresh)")
        if path is not None:
            snap = read_snapshot(path)
            if snap.integrator_kind is not None and snap.integrator_kind != kind:
                raise ValueError(
                    f"snapshot integrator {snap.integrator_kind!r} != config {kind!r}")
            carry = stepper.restore(snap.state, snap.aux)
            t0 = float(snap.state.time)
            snap_index = int(path.rsplit("_", 1)[1].split(".")[0]) + 1
            if "rng_key" in snap.attrs:
                rng_key = np.asarray(snap.attrs["rng_key"], np.uint32)
            restored_attrs = snap.attrs
            # drop stale rows written after this checkpoint (crash leftovers)
            # BEFORE the e0 baseline is read back below
            writer.truncate_diagnostics(t0)

    # jitted init that honours the pruned source set (same program per
    # bucket size); also reused by the SEV carry rebuild below
    def _init_fn(state, src):
        st = stepper if src is None else dataclasses.replace(
            stepper, force=_force_with(src))
        return st.init(state)

    _init_jit = jax.jit(_init_fn)

    def _macro_stepper(src):
        """The host-stepped stepper bound to the current pruned source set
        (plain dataclass replace — no tracing; macro force evals ARE the
        dispatch-splitting host loops)."""
        return stepper if src is None else dataclasses.replace(
            stepper, force=_force_with(src))

    def _reinit(old_carry, new_state, keep_steps=False):
        """Rebuild the carry after an out-of-band change: stale acc/jerk
        are re-derived under the CURRENT pruned force while the run
        counters survive (see _merge_reinit_carry for the timestep-state
        policy at re-partition vs SEV boundaries).

        Macro (host-stepped) steppers init eagerly: their force eval IS
        the dispatch-splitting host loop, which must not be traced (the
        same rationale as the advance path); the pruned source set is
        threaded by swapping the stepper's force — a cheap dataclass
        replace outside any jit."""
        c = (_macro_stepper(_prune["src"]).init(new_state) if host_stepping
             else _init_jit(new_state, _prune["src"]))
        return _merge_reinit_carry(c, old_carry, keep_steps)

    if carry is None:
        # fresh run: a previous run's diagnostics/snapshots in this dir
        # would otherwise be appended-to / shadow a later --resume
        writer.reset_outputs()
        if pruning:
            # partition BEFORE init so the cached acc is consistent; the
            # e0 baseline below absorbs the t=0 reduced-Hamiltonian offset
            # (no ledger entry at t0)
            _repartition(scene.state)
        if host_stepping:
            carry = _macro_stepper(_prune["src"]).init(scene.state)
        else:
            carry = _init_jit(scene.state, _prune["src"]) if pruning \
                else stepper.init(scene.state)
    elif pruning:
        # resume: recompute the partition the uninterrupted run was using
        # (history-free, so it matches bitwise); the restored aux is
        # already consistent with it — no reinit, and the jump at this
        # boundary is already inside the restored E_prune_cum ledger
        _repartition(carry.state)
        if "e_prune_cum" in restored_attrs:
            _prune["e_cum"] = float(restored_attrs["e_prune_cum"])

    # stellar evolution (models/stellar_evolution.py): tables are built
    # from the FRESH IC state (scene.state, deterministic from the config)
    # even on resume — the restored state already carries remnant masses
    # and the tables must describe the progenitors. The update itself is
    # idempotent, so re-applying it to a restored state is a no-op.
    sev = None
    _sev = {"e_cum": 0.0, "restored": False}
    if cfg.sev.kind not in (None, "none"):
        if cfg.sev.kind != "simple":
            raise ValueError(f"unknown sev kind {cfg.sev.kind!r}")
        from oc_nbody_tpu.models.stellar_evolution import make_stellar_evolution
        sev = make_stellar_evolution(cfg.sev, scene.units, scene.state,
                                     scene.rng_key)
        if "e_sev_cum" in restored_attrs:
            # the checkpoint of record for the cumulative jump energy: the
            # diagnostics-table truncation above drops the row written AT
            # t0, so its last surviving row predates any jump applied
            # exactly at the checkpoint boundary
            _sev["e_cum"] = float(restored_attrs["e_sev_cum"])
            _sev["restored"] = True
        if int(sev.count_pending(carry.state)):
            # stars already past t_death at t0 (epoch0_myr) — fold them
            # into the IC before the drift baseline e0 is measured
            carry = _reinit(carry, sev.update(carry.state))

    # donate the carry: the old state buffers are dead after each superstep,
    # halving device-memory pressure for large N (SURVEY.md §5 "donated-buffer
    # aliasing" — the stale-buffer risk is covered by tests/io determinism
    # and resume tests, which run the same jitted advance repeatedly).
    # Dispatches are step-bounded: very long single XLA programs can trip
    # runtime watchdogs; the host loops until each output time is reached.
    if host_stepping:
        # MacroKDK: advance_to_bounded IS the dispatch-splitting host
        # loop — wrapping it in jit would rebuild the one monolithic
        # program it exists to avoid; the pruned source set rides on the
        # stepper's force (round-4: escape.prune composes with macro)
        def advance_bounded(carry, t_target, src, max_steps):
            return _macro_stepper(src).advance_to_bounded(
                carry, t_target, max_steps)
    else:
        # the pruned source set rides as a jit ARGUMENT: new index values
        # at each re-partition reuse the compiled program; only a bucket-
        # size change (a different src shape) traces a new one
        def _adv_fn(carry, t_target, src, max_steps):
            st = stepper if src is None else dataclasses.replace(
                stepper, force=_force_with(src))
            return st.advance_to_bounded(carry, t_target, max_steps)

        advance_bounded = jax.jit(_adv_fn, donate_argnums=0,
                                  static_argnums=3)
    max_steps = max(1, int(out.max_steps_per_dispatch))
    # adaptive dispatch sizing: aim for ~20 s per dispatch (long single
    # dispatches trip the runtime watchdog, tiny ones pay dispatch
    # overhead). Sizes are a small static set so at most a few recompiles.
    # The ladder STARTS AT 1: the first dispatch probes the per-step cost
    # before committing to a size — at N=1M a single step takes seconds,
    # and a 256-step opener would be a program of many minutes before any
    # measurement existed.
    _sizes = [s for s in (1, 16, 256, 4096, 65536) if s <= max_steps]
    _sizes = _sizes or [max_steps]
    _target_s = 20.0
    _state = {"size": _sizes[0]}

    def advance_to(carry, t_target):
        while True:
            n0 = int(carry.n_steps)
            tic = _time.perf_counter()
            carry = advance_bounded(carry, t_target, _prune["src"],
                                    _state["size"])
            done = stepper.reached(carry, t_target)
            dn = int(carry.n_steps) - n0
            if dn > 0:
                per_step = (_time.perf_counter() - tic) / dn
                best = _sizes[0]
                for s in _sizes:
                    if s * per_step <= _target_s:
                        best = s
                _state["size"] = best
            if done:
                return carry
    extra_cols = _diag_extra_fn(cfg, scene)

    def _with_extras(row, state):
        return extra_cols(row, state) if extra_cols is not None else row

    if host_stepping:
        # the O(N²) potential is computed OUTSIDE the jit by the batched
        # kernels (same reason as advance above); the O(N) remainder of
        # the row stays one jitted program
        _diag_rest = jax.jit(
            lambda state, force, phi: _with_extras(diag_mod.compute_all(
                state, force, out.fractions, precomputed_phi=phi,
                core=out.core_diag), state))

        def compute_diag(state, force):
            # bind the evaluation time FIRST: a time-dependent external
            # raises on unbound evaluation, and the macro advance paths
            # all bind (leapfrog.py/hermite.py batched evals)
            force_t = force.at_time(state.time)
            _, phi_pair, phi_ext = force_t.accel_potential_batched(
                state.pos, state.mass, n_batches=stepper.n_batches)
            return _diag_rest(state, force, (phi_pair, phi_ext))
    else:
        compute_diag = jax.jit(
            lambda state, force: _with_extras(diag_mod.compute_all(
                state, force, out.fractions, f64_pairwise=out.diag_f64,
                core=out.core_diag), state)
        )

    if kind == "block":
        # the block integrator only synchronises on the dt_max block grid
        # (integer block times): an off-grid output target returns a state
        # whose large-rung particles still sit at earlier times — silently
        # wrong diagnostics/snapshots. Snap every output boundary to the
        # grid (at least one block); Myr-converted cadences practically
        # never land on it by themselves.
        g = float(cfg.integrator.dt_max)
        snapped = {
            "diag_every": max(g, round(out.diag_every / g) * g),
            "snap_every": max(g, round(out.snap_every / g) * g),
            "t_end": t0 + max(g, round((out.t_end - t0) / g) * g),
        }
        changed = {k: v for k, v in snapped.items()
                   if abs(v - getattr(out, k)) > 1e-12 * max(1.0, abs(v))}
        if changed:
            if out.stdout:
                olds = {k: getattr(out, k) for k in changed}
                print(f"block grid: snapped {olds} -> {changed} "
                      f"(dt_max = {g})")
            out = dataclasses.replace(out, **snapped)

    # ceil so a non-multiple t_end still gets simulated in full; the final
    # target is clamped to t_end exactly (ADVICE round-1)
    n_diag = max(1, math.ceil((out.t_end - t0) / out.diag_every - 1e-9))
    snap_stride = max(1, int(round(out.snap_every / out.diag_every)))

    from oc_nbody_tpu.utils.profiling import Stopwatch
    watch = Stopwatch()

    series: dict[str, list] = {}
    wall_start = _time.perf_counter()

    def emit(row):
        for k, v in row.items():
            series.setdefault(k, []).append(float(v))
        writer.append_diagnostics(row)

    # initial diagnostics row; on resume, keep the ORIGINAL t=0 energy as the
    # drift baseline (read back from the run's diagnostics table)
    if host_stepping:
        # the re-partition / SEV ledger bookkeeping needs E_tot at macro N:
        # the O(N²) potential must come from the batched dispatches, not
        # one monolithic in-jit eval (the same contract as compute_diag)
        _energy_rest = jax.jit(
            lambda state, force, phi: diag_mod.energies(
                state, force, precomputed_phi=phi)["E_tot"])

        def _energy_only(state, force):
            force_t = force.at_time(state.time)
            _, phi_pair, phi_ext = force_t.accel_potential_batched(
                state.pos, state.mass, n_batches=stepper.n_batches)
            return _energy_rest(state, force, (phi_pair, phi_ext))
    else:
        _energy_only = jax.jit(
            lambda state, force: diag_mod.energies(state, force)["E_tot"])

    # dynamical friction: emit the instantaneous drag magnitude — with
    # friction on, E_tot decays PHYSICALLY (dE/E is not a conservation
    # check; models/friction.py energy note)
    _friction = getattr(scene.force, "friction", None)
    if _friction is not None:
        import jax.numpy as _jnp

        _adf_jit = jax.jit(lambda state: _jnp.linalg.norm(
            _friction.accel_df(state.pos, state.vel, state.mass)))

    def _apply_partition(carry):
        """Boundary re-partition: when the source set changed, ledger the
        reduced-Hamiltonian jump (same state, old vs new sources) into
        E_prune_cum and rebuild the stale carry acc under the new set."""
        force_old = cur_force()
        if not _repartition(carry.state):
            return carry
        e_pre = float(jax.device_get(_energy_only(carry.state, force_old)))
        e_post = float(jax.device_get(_energy_only(carry.state, cur_force())))
        _prune["e_cum"] += e_post - e_pre
        return _reinit(carry, carry.state, keep_steps=True)

    row0 = jax.device_get(compute_diag(carry.state, cur_force()))
    e0 = float(row0["E_tot"])
    # |E_int(0)| — the cluster-internal energy scale. dE/E normalised by the
    # galaxy-dominated E_tot flatters orbit runs by orders of magnitude
    # (VERDICT round-1 item 4); dE_over_E_int is the honest per-crossing metric.
    e_int0 = abs(float(row0.get("E_int", e0)))
    ej0 = float(row0["E_J"]) if "E_J" in row0 else None
    if resume:
        prev = writer.read_diagnostics()
        if "E_tot" in prev and len(prev["E_tot"]):
            e0 = float(prev["E_tot"][0])
        if "E_int" in prev and len(prev["E_int"]):
            e_int0 = abs(float(prev["E_int"][0]))
        if ej0 is not None and "E_J" in prev and len(prev["E_J"]):
            ej0 = float(prev["E_J"][0])
        if (sev is not None and not _sev["restored"]
                and "E_sev_cum" in prev and len(prev["E_sev_cum"])):
            # fallback for pre-e_sev_cum snapshots: the last surviving
            # diagnostics row (may miss a jump applied exactly at the
            # checkpoint time — the snapshot attr is authoritative)
            _sev["e_cum"] = float(prev["E_sev_cum"][-1])
        if (pruning and "e_prune_cum" not in restored_attrs
                and "E_prune_cum" in prev and len(prev["E_prune_cum"])):
            _prune["e_cum"] = float(prev["E_prune_cum"][-1])

    def drift_cols(row):
        e = float(row["E_tot"])
        row["dE_over_E"] = (e - e0) / abs(e0) if e0 else 0.0
        row["dE_over_E_int"] = (e - e0) / e_int0 if e_int0 else 0.0
        if ej0 is not None and "E_J" in row:
            # Jacobi drift: the honest conservation check for a rigidly
            # rotating pattern (constant only after any growth ramp)
            row["dEJ_over_EJ"] = ((float(row["E_J"]) - ej0) / abs(ej0)
                                  if ej0 else 0.0)
        if hasattr(stepper, "rung_occupancy"):
            occ = np.asarray(jax.device_get(stepper.rung_occupancy(carry)))
            for k, c in enumerate(occ):
                row[f"rung_{k:02d}"] = float(c)
        if sev is not None:
            import jax.numpy as jnp
            row["M_tot"] = float(jnp.sum(
                carry.state.mass.astype(jnp.float64)))
            row["N_rem"] = float(sev.n_dead(carry.state))
            row["dM_sev"] = sev.mass_lost(carry.state)
            row["E_sev_cum"] = _sev["e_cum"]
        if pruning:
            row["E_prune_cum"] = _prune["e_cum"]
            row["N_cluster"] = float(_prune["n_cluster"])
        if _friction is not None:
            row["a_df"] = float(jax.device_get(_adf_jit(carry.state)))
        if sev is not None or pruning:
            # the honest conservation check under out-of-band energy
            # changes (SEV mass loss, re-partition jumps): E_tot minus the
            # ledgers should drift only by integrator error
            ledgers = _sev["e_cum"] + _prune["e_cum"]
            row["dE_cons_over_E_int"] = ((e - e0 - ledgers) / e_int0
                                         if e_int0 else 0.0)
        return row

    def _snap_attrs():
        attrs = {}
        if sev is not None:
            attrs["e_sev_cum"] = _sev["e_cum"]
        if pruning:
            attrs["e_prune_cum"] = _prune["e_cum"]
        return attrs or None

    row0 = drift_cols(row0)
    row0["wall_s"] = 0.0
    emit(row0)
    if not resume or snap_index == 0:
        writer.write(snap_index, carry.state, aux=stepper.checkpoint_aux(carry),
                     integrator_kind=kind, step=int(carry.n_steps),
                     rng_key=rng_key, extra_attrs=_snap_attrs())
        snap_index += 1

    for i in range(1, n_diag + 1):
        t_target = min(t0 + i * out.diag_every, out.t_end)
        with watch.phase("advance"):
            carry = advance_to(carry, t_target)
        e_pre = None
        if sev is not None and int(sev.count_pending(carry.state)):
            # one or more stars crossed t_death in this interval: measure
            # E_tot before the mass drop + kick (same positions), apply
            # it, rebuild the carry (stale acc/jerk/rungs), and account
            # the jump into E_sev_cum after the post-update row below
            with watch.phase("stellar_evolution"):
                e_pre = float(jax.device_get(
                    compute_diag(carry.state, cur_force())["E_tot"]))
                carry = _reinit(carry, sev.update(carry.state))
                if pruning:
                    # account the SEV jump NOW (still under the old
                    # partition): the row-based accounting below would
                    # otherwise also absorb this boundary's re-partition
                    # jump, which _apply_partition ledgers separately
                    _sev["e_cum"] += float(jax.device_get(_energy_only(
                        carry.state, cur_force()))) - e_pre
                    e_pre = None
        if pruning:
            with watch.phase("escape_prune"):
                carry = _apply_partition(carry)
        with watch.phase("diagnostics"):
            row = jax.device_get(compute_diag(carry.state, cur_force()))
        if e_pre is not None:
            _sev["e_cum"] += float(row["E_tot"]) - e_pre
        row = drift_cols(row)
        e = float(row["E_tot"])
        row["wall_s"] = _time.perf_counter() - wall_start
        emit(row)

        if not np.isfinite(e):
            writer.write(snap_index, carry.state,
                         aux=stepper.checkpoint_aux(carry),
                         integrator_kind=kind, step=int(carry.n_steps),
                         rng_key=rng_key, extra_attrs=_snap_attrs())
            writer.flush()
            raise FloatingPointError(
                f"non-finite total energy at t={float(carry.state.time):.6g}; "
                f"emergency snapshot written to {out.out_dir}"
            )

        if i % snap_stride == 0 or i == n_diag:
            with watch.phase("snapshot"):
                writer.write(snap_index, carry.state,
                             aux=stepper.checkpoint_aux(carry),
                             integrator_kind=kind, step=int(carry.n_steps),
                             rng_key=rng_key, extra_attrs=_snap_attrs())
            snap_index += 1

        if out.stdout:
            print(
                f"t={float(carry.state.time):9.4f}  E={e:+.9e}  "
                f"dE/E={row['dE_over_E']:+.3e}  steps={int(carry.n_steps)}  "
                f"wall={row['wall_s']:.1f}s", flush=True,
            )
        if progress is not None:
            progress(i, n_diag, row)

    writer.flush()
    wall = _time.perf_counter() - wall_start
    sim_myr = (float(carry.state.time) - t0) * scene.units.time_myr
    wall_per_myr = wall / sim_myr if sim_myr > 0 else math.nan
    if out.stdout:
        print(f"wall-clock per simulated Myr: {wall_per_myr:.4g} s/Myr "
              f"({sim_myr:.4g} Myr simulated in {wall:.1f}s incl. compile)")
        print("phase timings:\n" + watch.summary())
    return RunResult(
        state=carry.state, carry=carry,
        diagnostics={k: np.asarray(v) for k, v in series.items()},
        out_dir=out.out_dir, wall_time_s=wall, n_steps=int(carry.n_steps),
        wall_per_myr=wall_per_myr,
    )
