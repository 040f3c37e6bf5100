"""The Pallas (Triton route) pairwise kernels through the interpreter.

``ops/triton_gravity.py`` compiles only for the GPU; ``interpret=True``
runs the same kernel bodies on the CPU. These tests hold them to the f64
reference (``ops/gravity.py`` in float64) over the shapes the wrappers
must handle — rows == sources, rows ⊂ sources, N not a multiple of the
block, N below one block, the split-source grid — plus eps = 0 self pairs,
vmap, the pruned and active-row ForceModel paths, and a lowering of every
kernel to Triton IR for the CUDA platform (no card needed for that step).
The compiled kernels are checked on the card by the ``gpu``-marked tests
at the end and by chip_smoke.py.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oc_nbody_tpu.forces import make_force_model
from oc_nbody_tpu.ops import gravity, triton_gravity as tg

OPS = ["a", "ap", "aj"]


@pytest.fixture(autouse=True)
def _fresh_sweep():
    """Tile overrides last one test: ``_sweep``'s trace cache is cleared
    after each (this teardown runs after monkeypatch's undo)."""
    yield
    tg._sweep.clear_cache()


def _set_tiles(monkeypatch, tiles, group, min_programs=None):
    """Override the kernels' tile constants for this test."""
    for kind in tg.TILES:
        monkeypatch.setitem(tg.TILES, kind, tiles)
    monkeypatch.setattr(tg, "GROUP", group)
    if min_programs is not None:
        monkeypatch.setattr(tg, "MIN_PROGRAMS", min_programs)
    tg._sweep.clear_cache()


@pytest.fixture
def small_tiles(monkeypatch):
    """16 rows × 32 sources a tile, compensated every 2 tiles: small
    shapes then cover several row blocks, tiles and groups."""
    _set_tiles(monkeypatch, tiles=(16, 32, 4, 2), group=2)


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    vel = jnp.asarray(0.3 * rng.normal(size=(n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 1.5, size=n) / n, jnp.float32)
    return pos, vel, mass


def _run(op, rows, vrows, src, svel, mass, eps):
    """(kernel outputs, f64 reference outputs) for ``op``."""
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    if op == "a":
        got = (tg.accel_rows(rows, src, mass, eps, 1.3, interpret=True),)
        ref = (gravity.accel_rows(f64(rows), f64(src), f64(mass), eps, 1.3),)
    elif op == "ap":
        got = tg.accel_potential_rows(rows, src, mass, eps, 1.3,
                                      interpret=True)
        ref = gravity.accel_potential_rows(f64(rows), f64(src), f64(mass),
                                           eps, 1.3)
    else:
        got = tg.accel_jerk_rows(rows, vrows, src, svel, mass, eps, 1.3,
                                 interpret=True)
        ref = gravity.accel_jerk_rows(f64(rows), f64(vrows), f64(src),
                                      f64(svel), f64(mass), eps, 1.3)
    return got, ref


def _max_rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if ref.ndim == 1:
        return float(np.max(np.abs(x - ref) / np.abs(ref)))
    return float(np.max(np.linalg.norm(x - ref, axis=1)
                        / np.linalg.norm(ref, axis=1)))


# (rows, sources, small tiles?): rows == sources; rows a subset of the
# sources; N not a multiple of the block; N below one block; a single row
SHAPES = {
    "rows_eq_sources": (200, 200, False),
    "rows_subset": (37, 300, True),
    "n_not_block_multiple": (100, 100, True),
    "n_below_one_block": (5, 3, False),
    "single_row": (1, 50, True),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("op", OPS)
def test_rows_kernel_matches_f64_reference(op, shape, monkeypatch):
    nr, ns, small = SHAPES[shape]
    if small:
        _set_tiles(monkeypatch, tiles=(16, 32, 4, 2), group=2)
    pos, vel, mass = _cloud(ns)
    got, ref = _run(op, pos[:nr], vel[:nr], pos, vel, mass, 0.05)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert g.dtype == jnp.float32
        assert _max_rel(g, r) < 2e-5, (op, shape, _max_rel(g, r))


@pytest.mark.parametrize("split", [False, True], ids=["one_pass", "split"])
@pytest.mark.parametrize("op", OPS)
def test_split_source_grid(op, split, monkeypatch):
    """Few row blocks: the sources are split over a second grid axis and
    the partials summed outside the kernel; both grids give the same
    answer to f32 summation order."""
    _set_tiles(monkeypatch, tiles=(16, 32, 4, 2), group=2,
               min_programs=64 if split else 1)
    pos, vel, mass = _cloud(300, seed=2)
    got, ref = _run(op, pos[:20], vel[:20], pos, vel, mass, 0.05)
    for g, r in zip(got, ref):
        assert _max_rel(g, r) < 2e-5


@pytest.mark.parametrize("n_row_blocks,n_tiles,expect", [
    (1, 1, (1, 1)),        # one tile: nothing to split
    (1, 100, (100, 1)),    # one row block: a program per tile, up to 264
    (1, 1000, (250, 4)),   # capped near MIN_PROGRAMS, tiles spread evenly
    (8, 256, (32, 8)),     # 512 active rows vs 32k sources
    (264, 512, (1, 512)),  # enough row blocks: no split
    (1024, 8, (1, 8)),
])
def test_n_split(n_row_blocks, n_tiles, expect):
    n_split, per = tg._n_split(n_row_blocks, n_tiles, tg.MIN_PROGRAMS)
    assert (n_split, per) == expect
    assert n_split * per >= n_tiles > (n_split - 1) * per


@pytest.mark.parametrize("op", OPS)
def test_eps0_self_pairs_are_guarded(op, small_tiles):
    """eps = 0 with rows == sources: r = 0 self pairs and the zero-mass
    padding give 0, not NaN (the u > 0 guard)."""
    pos, vel, mass = _cloud(90, seed=3)
    got, ref = _run(op, pos, vel, pos, vel, mass, 0.0)
    for g, r in zip(got, ref):
        assert bool(jnp.all(jnp.isfinite(g)))
        assert _max_rel(g, r) < 1e-4


@pytest.mark.parametrize("op", OPS)
def test_single_chip_wrappers_match_gravity(op):
    """accel / accel_potential / accel_jerk: centre, cast, rows ==
    sources, self term of phi removed — ops.gravity's contract."""
    key = jax.random.PRNGKey(5)
    pos = 100.0 + jax.random.normal(key, (150, 3), jnp.float64)
    vel = 0.3 * jax.random.normal(jax.random.PRNGKey(6), (150, 3))
    mass = jnp.full((150,), 1.0 / 150)
    if op == "a":
        got = (tg.accel(pos, mass, 0.05, 1.0, interpret=True),)
        ref = (gravity.accel(pos, mass, 0.05, 1.0,
                             compute_dtype=jnp.float64),)
    elif op == "ap":
        got = tg.accel_potential(pos, mass, 0.05, 1.0, interpret=True)
        ref = gravity.accel_potential(pos, mass, 0.05, 1.0,
                                      compute_dtype=jnp.float64)
    else:
        got = tg.accel_jerk(pos, vel, mass, 0.05, 1.0, interpret=True)
        ref = gravity.accel_jerk(pos, vel, mass, 0.05, 1.0,
                                 compute_dtype=jnp.float64)
    for g, r in zip(got, ref):
        assert g.dtype == pos.dtype
        assert _max_rel(g, r) < 2e-5


@pytest.mark.parametrize("op", OPS)
def test_kernels_under_vmap(op, small_tiles):
    """A batch of independent systems (the ensemble's vmapped members)."""
    batch = [_cloud(64, seed=s) for s in range(3)]
    pos = jnp.stack([b[0] for b in batch])
    vel = jnp.stack([b[1] for b in batch])
    mass = jnp.stack([b[2] for b in batch])
    if op == "a":
        fn = functools.partial(tg.accel_rows, interpret=True)
        out = jax.vmap(lambda p, m: (fn(p, p, m, 0.05, 1.3),))(pos, mass)
    elif op == "ap":
        fn = functools.partial(tg.accel_potential_rows, interpret=True)
        out = jax.vmap(lambda p, m: fn(p, p, m, 0.05, 1.3))(pos, mass)
    else:
        fn = functools.partial(tg.accel_jerk_rows, interpret=True)
        out = jax.vmap(lambda p, v, m: fn(p, v, p, v, m, 0.05, 1.3))(
            pos, vel, mass)
    for i, (p, v, m) in enumerate(batch):
        _, ref = _run(op, p, v, p, v, m, 0.05)
        for o, r in zip(out, ref):
            assert _max_rel(o[i], r) < 2e-5


def _models(**kw):
    jnp_fm = make_force_model(eps=0.05, backend="jnp", **kw)
    pal_fm = make_force_model(eps=0.05, backend="pallas", interpret=True,
                              **kw)
    return jnp_fm, pal_fm


@pytest.mark.parametrize("method", ["accel", "accel_potential",
                                    "accel_jerk", "accel_jerk_on_rows"])
def test_force_model_pallas_matches_jnp(method):
    from oc_nbody_tpu.models.plummer import plummer
    st = plummer(200, jax.random.PRNGKey(7))
    ref_fm, pal_fm = _models()
    if method == "accel":
        args = (st.pos, st.mass)
    elif method == "accel_potential":
        args = (st.pos, st.mass)
    elif method == "accel_jerk":
        args = (st.pos, st.vel, st.mass)
    else:
        args = (st.pos[:24], st.vel[:24], st.pos, st.vel, st.mass)
    got = jax.jit(getattr(pal_fm, method))(*args)
    ref = jax.jit(getattr(ref_fm, method))(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        if float(jnp.max(jnp.abs(r))) == 0.0:   # phi_ext without a field
            assert float(jnp.max(jnp.abs(g))) == 0.0
            continue
        assert _max_rel(g, r) < 1e-5, method


@pytest.mark.parametrize("method", ["accel", "accel_potential",
                                    "accel_jerk"])
def test_pruned_bucket_pallas_matches_jnp(method):
    """Escape pruning's two rows-vs-sources sweeps (all rows × the
    cluster bucket, bucket rows × all sources) through the kernels."""
    from oc_nbody_tpu import escape
    from oc_nbody_tpu.models.plummer import plummer
    st = plummer(256, jax.random.PRNGKey(0))
    r = np.linalg.norm(np.asarray(st.pos), axis=1)
    mask = r <= np.quantile(r, 0.2)
    idx, wgt, _ = escape.build_sources(mask, 16)
    src = (jnp.asarray(idx), jnp.asarray(wgt),
           jnp.asarray(mask.astype(np.float64)))
    ref_fm, pal_fm = (fm.with_sources(*src) for fm in _models())
    args = ((st.pos, st.vel, st.mass) if method == "accel_jerk"
            else (st.pos, st.mass))
    got = jax.jit(getattr(pal_fm, method))(*args)
    ref = jax.jit(getattr(ref_fm, method))(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got[:2], ref[:2]):
        assert _max_rel(g, r) < 1e-5, method


@pytest.mark.parametrize("op", OPS)
def test_kernels_lower_to_triton_for_cuda(op):
    """Every kernel lowers to Triton IR for the CUDA platform — the part
    of the GPU compile that runs in Python (block shapes, loads, the
    loop), checked here without a card. Triton's own compile to PTX
    happens on the card."""
    from jax.export import DisabledSafetyCheck, export
    pos, vel, mass = _cloud(300)
    if op == "a":
        fn = lambda p, v, m: tg.accel_rows(p[:40], p, m, 0.05)  # noqa: E731
    elif op == "ap":
        fn = lambda p, v, m: tg.accel_potential_rows(  # noqa: E731
            p[:40], p, m, 0.05)
    else:
        fn = lambda p, v, m: tg.accel_jerk_rows(  # noqa: E731
            p[:40], v[:40], p, v, m, 0.05)
    exp = export(jax.jit(fn), platforms=["cuda"], disabled_checks=[
        DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
            pos, vel, mass)
    assert "xla.gpu.triton" in exp.mlir_module()


@pytest.mark.parametrize("name", tg.DIALECT_LOOKUPS)
def test_dialect_lookup_misses_are_cached(name):
    """The Triton dialect module lookups that MLIR's bindings repeat for
    every op of a kernel's lowering are answered from sys.modules (a
    recorded miss, or the module itself), never by a new path search."""
    import sys
    assert name in sys.modules
    if sys.modules[name] is None:
        with pytest.raises(ImportError, match="halted"):
            importlib.import_module(name)


# --------------------------------------------------------------------------
# on the card (skip elsewhere): the compiled kernels at a real width
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_compiled_kernels_match_f64_on_gpu(op):
    from oc_nbody_tpu.models.plummer import plummer
    st = plummer(16384, jax.random.PRNGKey(0))
    args = ((st.pos, st.vel, st.mass) if op == "aj"
            else (st.pos, st.mass))
    name = {"a": "accel", "ap": "accel_potential", "aj": "accel_jerk"}[op]
    got = jax.jit(getattr(tg, name))(*args, 1.0 / 512)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(getattr(gravity, name),
                                        compute_dtype=jnp.float64))(
            *args, 1.0 / 512)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert _max_rel(g, r) < 1e-4
