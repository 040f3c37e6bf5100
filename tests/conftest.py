"""Test harness configuration.

By default the tests run on CPU with 8 emulated devices (SURVEY.md §4.3):
the standard JAX technique for exercising multi-device `shard_map` paths
without a cluster. ``--platform gpu`` runs them on the GPU instead; tests
marked ``gpu`` need the card and skip elsewhere:

    python -m pytest tests -m gpu --platform gpu

The platform is set in ``pytest_configure``, before any test module
initialises a JAX backend.
"""
import os

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Persistent compilation cache for the tests: OPT-IN ONLY
# (OCN_TEST_CACHE=1). Two measured failure modes made the default unsafe
# for a full-suite run (round 5): (a) entries compiled on a previous
# session's machine with a different CPU feature set segfault on load —
# mitigated by keying the directory with utils/cache.host_tag — and (b)
# XLA:CPU executable (de)serialization itself segfaulted twice at ~85%
# of a full run (once in get_executable_and_time on a fresh host-keyed
# cache, once in put_executable_and_time), a flaky native crash under
# long-process load that passes in isolation. Iterating on a single test
# file? export OCN_TEST_CACHE=1 for fast repeats.
if os.environ.get("OCN_TEST_CACHE") == "1":
    from oc_nbody_tpu.utils.cache import host_tag

    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        f".jax_cache-{host_tag()}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
else:
    # the CLI tests call __main__.main() in-process, whose
    # enable_compile_cache() would otherwise install the cache
    # PROCESS-GLOBALLY mid-suite (the third ~85% segfault's cause —
    # cache writes crash in XLA:CPU executable serialization under
    # long-run load); this env makes it a no-op inside the tests
    os.environ["OCN_DISABLE_COMPILE_CACHE"] = "1"

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--platform", default="cpu", choices=("cpu", "gpu"),
                     help="JAX platform for the tests (default: cpu with 8 "
                          "emulated devices)")


def pytest_configure(config):
    if config.getoption("--platform") == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    else:
        jax.config.update("jax_platforms", "cuda")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX's backend is a GPU; decided
    here, at run time, never while a module is imported."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with --platform gpu on the card)")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated per-process XLA state. Four full-suite runs
    segfaulted (~85%, always while COMPILING programs of
    tests/unit/test_timedep.py — a file that passes in isolation), each
    one frame deep in compile/serialize machinery with hundreds of live
    executables from earlier modules. Clearing the jit caches at module
    boundaries keeps the compiler's working set bounded; measured to let
    the full suite complete."""
    yield
    jax.clear_caches()
