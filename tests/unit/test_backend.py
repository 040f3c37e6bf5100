"""The one backend decision (ops/backend.py), the compile-cache rules
(utils/cache.py) and chip_smoke.py's refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from oc_nbody_tpu.ops import backend, gravity, triton_gravity

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("name,platform,interpret,expect", [
    ("auto", "gpu", False, "pallas"),
    ("auto", "cpu", False, "jnp"),
    ("auto", "cpu", True, "jnp"),
    ("jnp", "gpu", False, "jnp"),
    ("jnp", "cpu", False, "jnp"),
    ("pallas", "gpu", False, "pallas"),
    ("pallas", "cpu", True, "pallas"),
])
def test_resolve_backend(name, platform, interpret, expect):
    assert backend.resolve_backend(name, platform, interpret) == expect


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_pallas_off_gpu_raises(platform):
    with pytest.raises(ValueError, match="only for the GPU"):
        backend.resolve_backend("pallas", platform)


def test_unknown_backend_raises():
    from oc_nbody_tpu.forces import make_force_model
    from oc_nbody_tpu.parallel import make_mesh, make_sharded_force
    with pytest.raises(ValueError, match="unknown force backend"):
        backend.resolve_backend("mosaic")
    with pytest.raises(ValueError, match="unknown force backend"):
        make_force_model(eps=0.1, backend="mosaic")
    with pytest.raises(ValueError, match="only for the GPU"):
        make_force_model(eps=0.1, backend="pallas")
    with pytest.raises(ValueError, match="only for the GPU"):
        make_sharded_force(eps=0.1, mesh=make_mesh(1), backend="pallas")


def test_default_platform_is_jax_default_backend():
    assert backend.resolve_backend("auto") == (
        "pallas" if jax.default_backend() == "gpu" else "jnp")


def test_pair_ops_pick_the_backend_module():
    ops = backend.pair_ops("jnp")
    assert ops.accel_rows is gravity.accel_rows
    assert ops.accel is gravity.accel
    kops = backend.pair_ops("pallas", interpret=True)
    assert kops.accel_jerk_rows.func is triton_gravity.accel_jerk_rows
    assert kops.accel_jerk_rows.keywords == {"interpret": True}


# ---- compile cache -------------------------------------------------------

@pytest.fixture
def cache_env(monkeypatch):
    """Run enable_compile_cache against a recorder instead of jax.config."""
    from oc_nbody_tpu.utils import cache
    seen = {}
    monkeypatch.delenv("OCN_DISABLE_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return cache, seen


def test_cache_fixed_checkout_dir(cache_env, monkeypatch):
    cache, seen = cache_env
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_compile_cache()
    assert seen["jax_compilation_cache_dir"] == os.path.join(REPO,
                                                             ".jax_cache")


def test_cache_env_dir_is_left_to_jax(cache_env, monkeypatch, tmp_path):
    cache, seen = cache_env
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cache.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in seen
    assert seen["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_disabled_for_tests(cache_env, monkeypatch):
    cache, seen = cache_env
    monkeypatch.setenv("OCN_DISABLE_COMPILE_CACHE", "1")
    cache.enable_compile_cache()
    assert seen == {}


# ---- chip_smoke.py without a GPU ------------------------------------------

def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    res = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the
    repository: no GPU here, and no package beside it — never exit 0."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
