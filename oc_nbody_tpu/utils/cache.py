"""Persistent XLA compilation cache setup.

Every entry point (CLI, bench) keeps compiled programs on disk so a second
run of the same shapes skips compilation. Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already uses that directory and nothing is set here; otherwise
the cache lives at the fixed ``<checkout>/.jax_cache`` (a fixed path: the
path is part of the cache key). Call before the first jit execution.
"""
from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def host_tag() -> str:
    """Short fingerprint of this host's CPU feature set (the tests' opt-in
    CPU cache only).

    XLA:CPU executables compiled with another host's feature flags load
    and then crash (a full test run died loading an entry whose compile
    features included ``prefer-no-scatter`` the host lacked), so the
    tests key their CPU cache directory by the feature set."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha1(f"{platform.machine()}|{flags}".encode()).hexdigest()
    return h[:12]


def enable_compile_cache() -> None:
    # OCN_DISABLE_COMPILE_CACHE=1 makes this a no-op. The test harness
    # sets it: CLI tests call __main__.main() IN-PROCESS, and the cache
    # dir it installs is process-global — a later unrelated test's
    # compile then writes a cache entry through XLA:CPU executable
    # serialization, which segfaulted full-suite runs twice at ~85%
    # (see tests/conftest.py).
    if os.environ.get("OCN_DISABLE_COMPILE_CACHE") == "1":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
