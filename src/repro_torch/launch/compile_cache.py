"""Persistent kernel build cache: each kernel library is built once, ever
(the counterpart of ``repro.launch.compile_cache``).

The JAX package persists XLA's compiled executables. The port's "compile"
is ``nvcc``: ``kernels._build`` turns each ``csrc/*.cu`` into a shared
library named by a hash of the source, the shared headers and the flags,
and loads an existing one instead of building it again. This module picks
the directory those libraries live in, with the JAX module's policy:

* The default is the package's ``kernels/build/`` (git-ignored).
* ``REPRO_COMPILE_CACHE_DIR`` moves it.
* ``REPRO_NO_COMPILE_CACHE`` (any non-empty value) turns the persistent
  cache off: the process builds into a fresh directory of its own
  (removed when it exits), so every kernel it loads is built anew; the
  escape hatch for cold-start measurements and cache tests.

Enabling is idempotent: the first call fixes the directory for the
process, later calls and later changes of the environment leave it.
Nothing runs at import time; ``kernels._build`` calls ``build_dir`` when a
kernel is first built or loaded.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

_ENABLED: str | None = None  # cache dir once enabled, for introspection
_FRESH: str | None = None  # this process's own directory under REPRO_NO_COMPILE_CACHE


def default_cache_dir() -> Path:
    """The package's ``kernels/build`` directory."""
    return Path(__file__).resolve().parents[1] / "kernels" / "build"


def enable_persistent_cache() -> str | None:
    """Fix the persistent build directory for this process; returns it, or
    None under ``REPRO_NO_COMPILE_CACHE``. Safe to call any number of times;
    honors ``REPRO_COMPILE_CACHE_DIR``."""
    global _ENABLED
    if os.environ.get("REPRO_NO_COMPILE_CACHE"):
        return None
    if _ENABLED is not None:
        return _ENABLED
    _ENABLED = os.environ.get("REPRO_COMPILE_CACHE_DIR") or str(default_cache_dir())
    return _ENABLED


def enabled_dir() -> str | None:
    """The active cache directory, or None if disabled/not yet enabled."""
    return _ENABLED


def build_dir() -> Path:
    """Where kernel libraries are built and loaded: the persistent cache, or
    under ``REPRO_NO_COMPILE_CACHE`` this process's fresh directory."""
    global _FRESH
    cache = enable_persistent_cache()
    if cache is not None:
        return Path(cache)
    if _FRESH is None:
        _FRESH = tempfile.mkdtemp(prefix="repro_torch_build_")
        atexit.register(shutil.rmtree, _FRESH, True)
    return Path(_FRESH)
