"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface; no PyTorch headers are included, so a
build takes seconds; ``build_all`` starts one ``nvcc`` per source at once.
Libraries go into ``kernels/build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here
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
# -Xptxas -v: ptxas reports each kernel's registers, spills and static
# shared memory; build_all returns that report (chip_smoke.py logs it)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# decode_attention_<dt>(q, k_pool, v_pool, table, lengths, out, partials,
#   counters, B, Hq, Hkv, D, n_blocks, block_size, n_pages, has_window, window,
#   has_softcap, softcap, scale, splits, smem, sms, device, stream): splits and
#   smem from decode_attention.decode_plan
_DECODE = [_P] * 8 + [_I] * 10 + [_F, _F] + [_I] * 4 + [_P]
# flash_attention_fwd_<dt>(q, k, v, o, lse, B, Hq, Hkv, S, Sk, D, causal,
#   has_window, window, has_softcap, softcap, scale, device, stream)
_FLASH = [_P] * 5 + [_I] * 10 + [_F, _F, _I, _P]
# the bf16 (sm90) entry points take the tile plan's dynamic shared memory
# before the device: ..., scale, smem, device, stream (backward: smem_dq,
# smem_dkv)
_FLASH_SM90 = [_P] * 5 + [_I] * 10 + [_F, _F, _I, _I, _P]
# flash_attention_bwd_<dt>(q, k, v, o, lse, do, delta, dq, dk, dv, B, Hq, Hkv,
#   S, Sk, D, causal, has_window, window, has_softcap, softcap, scale, device,
#   stream)
_FLASH_BWD = [_P] * 10 + [_I] * 10 + [_F, _F, _I, _P]
_FLASH_BWD_SM90 = [_P] * 10 + [_I] * 10 + [_F, _F, _I, _I, _I, _P]
_I64 = ctypes.c_int64
# ssd_chunk_fwd_f32(xdt, cum, B, C, y, st, BC, Q, nh, hd, ds, G, smem, device,
#   stream): G and smem from ssd_scan.ssd_plan
_SSD_FWD = [_P] * 6 + [_I] * 8 + [_P]
# ssd_chunk_bwd_f32(xdt, cum, B, C, dy, dst, scratch, dxdt, dcum, dB, dC, BC, Q,
#   nh, hd, ds, GR, GC, smem_rows, smem_cols, device, stream)
_SSD_BWD = [_P] * 11 + [_I] * 10 + [_P]
# C signatures of each library's entry points: name -> argtypes (restype
# int), or name -> (argtypes, restype)
SIGNATURES = {
    "sparse_saga": {
        "sparse_axpy_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_axpy_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_dot_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "sparse_dot_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "decode_attention": {"decode_attention_bf16": _DECODE, "decode_attention_f32": _DECODE},
    # float32 attention: the CUDA-core kernels; bfloat16: wgmma + TMA forward,
    # tensor-core (mma.sync) backward
    "flash_attention": {"flash_attention_fwd_f32": _FLASH},
    "flash_attention_bwd": {"flash_attention_bwd_f32": _FLASH_BWD},
    "flash_attention_sm90": {"flash_attention_fwd_bf16": _FLASH_SM90},
    "flash_attention_bwd_sm90": {"flash_attention_bwd_bf16": _FLASH_BWD_SM90},
    # block_topk_f32(x, vals, idx, nb, block, k, stages, cap, smem, grid,
    #   device, stream): the plan of topk_compress.topk_plan
    "topk_compress": {
        "block_topk_f32": [_P, _P, _P] + [_I] * 8 + [_P],
        # the plan's dynamic shared memory: (block, k, stages, cap)
        "block_topk_smem_f32": ([_I] * 4, ctypes.c_longlong),
        "block_topk_k_max_f32": ([], _I),
    },
    "ssd_scan": {
        "ssd_chunk_fwd_f32": _SSD_FWD,
        "ssd_chunk_bwd_f32": _SSD_BWD,
        # floats of scratch the backward needs: (BC, Q, nh, hd, ds, GR) -> int64
        "ssd_chunk_bwd_scratch_f32": ([_I] * 6, _I64),
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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))  # shared by sources
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu``; (output path, temp path, process)."""
    out = _library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc) -> str:
    """Wait for one nvcc; raise on failure; returns its output."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(proc.args)}\n{stdout}\n{stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return stdout + stderr


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory (if not built)."""
    out = _library_path(name)
    if not out.exists():
        _finish(name, *_start(name))
    return out


def build_all() -> dict[str, str]:
    """Build every library with one nvcc each, all started together.
    Returns {name: nvcc output} for the ones that were not built yet."""
    running = [(n, *_start(n)) for n in SIGNATURES if not _library_path(n).exists()]
    return {n: _finish(n, out, tmp, proc) for n, out, tmp, proc in running}


@functools.cache
def load_library(name: str = "sparse_saga") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library with typed entry points."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, sig in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = sig if isinstance(sig, tuple) else (sig, ctypes.c_int)
    # every library exports error_string(int) -> const char*
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def stream(t) -> int:
    """The handle of the current CUDA stream of tensor t's device, read as
    Triton's launcher reads it, through torch's private
    ``torch._C._cuda_getCurrentRawStream``: without building a
    ``torch.cuda.Stream`` object (this is on every launch path). It is the
    port's only private torch API; ``tests/test_torch_hygiene.py`` keeps it
    here alone and ``tests/test_torch_cuda.py`` checks it on the card."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def plain_or_raise(t) -> bool:
    """True for a CPU tensor (the wrapper uses the plain version), False for
    a CUDA tensor (it launches the kernel); any other device raises."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {t.device}: CPU or CUDA only")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
