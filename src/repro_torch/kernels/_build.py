"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface; no PyTorch headers are included, so a
build takes seconds. Libraries go into ``kernels/build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import time: ``load_library`` is called by the kernel wrappers (and
by ``chip_smoke.py``, which times the build).

A machine without ``nvcc`` cannot build: ``load_library`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of each library's entry points: name -> argtypes (restype int)
SIGNATURES = {
    "sparse_saga": {
        "sparse_axpy_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_axpy_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_dot_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_dot_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built on this machine"
    )


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory (if not built)."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def load_library(name: str = "sparse_saga") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library with typed entry points."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    # every library exports error_string(int) -> const char*
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
