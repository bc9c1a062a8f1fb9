"""The DSBA per-node sparse kernels: wrappers around ``csrc/sparse_saga.cu``.

Replaces the Pallas TPU kernels of ``repro/kernels/sparse_saga.py``
(``sparse_dot`` / ``_dot_kernel`` and ``sparse_axpy`` / ``_axpy_kernel``).
There the gather and the scatter are one-hot matrix products, a workaround
for the TPU's missing VMEM gather; on Hopper both are native gathers and
scatters of global memory, so the CUDA kernels index ``psi[n, idx]``
directly.

Bound on an H100 at the main path's shapes (N = 10, D = 47,236, k = 74,
float64): ``sparse_axpy`` moves 2*N*D*8 B (about 7.6 MB, ~2.3 us at
3.35 TB/s) and ``sparse_dot`` about 15 KB; both are launch-latency bound at
this size. The design answers that only in part: pass 1 of ``sparse_axpy``
is one coalesced elementwise sweep, its pass 2 and ``sparse_dot`` give each
node one warp that walks its k entries 32 at a time; folding the whole step
into fewer launches is later work. See the header of the ``.cu`` file for the arithmetic policy
(f64 ``sparse_axpy`` is bit-equal to ``ref.sparse_axpy_ref``).

Each wrapper takes the plain version (``kernels.ref``) for a tensor on the
CPU, and only then; for a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts ``__global__`` launches, so a run can show
that it went through the kernel: one per ``sparse_dot`` call, two per
``sparse_axpy`` call (pass 1 and pass 2; one when k = 0, which skips
pass 2).

Index contract: ``idx`` is int32 in ``[0, D)``; padded entries are
``idx = 0, val = 0``. Out-of-range indices are skipped by the kernel and
rejected by the plain version's indexing; callers must not rely on either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sparse_axpy_ref, sparse_dot_ref

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_MAX_GRID_Y = 65535  # pass 1 puts the node index on the grid's y axis


def _check_inputs(psi, idx, val, vectors=()):
    """Validate what the kernels take; returns (N, D, K)."""
    if psi.dtype not in _DTYPES:
        raise TypeError(f"psi must be float32 or float64, got {psi.dtype}")
    if psi.ndim != 2:
        raise ValueError(f"psi must be (N, D), got {tuple(psi.shape)}")
    n, d = psi.shape
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.ndim != 2 or idx.shape[0] != n or val.shape != idx.shape:
        raise ValueError(
            f"idx/val must both be (N, k) with N={n}; got {tuple(idx.shape)} "
            f"and {tuple(val.shape)}"
        )
    for name, t in (("val", val), *vectors):
        if t.dtype != psi.dtype:
            raise TypeError(f"{name} must be {psi.dtype}, got {t.dtype}")
    for name, t in vectors:
        if t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    tensors = (("psi", psi), ("idx", idx), ("val", val), *vectors)
    for name, t in tensors:
        if t.device != psi.device:
            raise ValueError(f"{name} is on {t.device}, psi on {psi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n > _MAX_GRID_Y or d >= 2**31 or idx.shape[1] >= 2**31:
        raise ValueError(f"shape (N={n}, D={d}, k={idx.shape[1]}) too large")
    return n, d, idx.shape[1]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _plain_or_raise(t: torch.Tensor) -> bool:
    """True for a CPU tensor (use the plain version), False for CUDA."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: CPU or CUDA only")
    return False


def sparse_dot(psi: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_k val[n,k] * psi[n, idx[n,k]]  ->  (N,), dtype of psi."""
    if _plain_or_raise(psi):
        return sparse_dot_ref(psi, idx, val)
    n, d, k = _check_inputs(psi, idx, val)
    out = torch.empty((n,), dtype=psi.dtype, device=psi.device)
    lib = _build.load_library()
    fn = getattr(lib, f"sparse_dot_{_DTYPES[psi.dtype]}")
    code = fn(psi.data_ptr(), idx.data_ptr(), val.data_ptr(), out.data_ptr(),
              n, d, k, psi.device.index or 0, _stream(psi))
    _build.check(lib, code, "sparse_dot launch")
    sparse_dot.launches += 1
    return out


sparse_dot.launches = 0


def sparse_axpy(
    psi: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    coef: torch.Tensor,
    rho: torch.Tensor,
) -> torch.Tensor:
    """out[n] = rho[n] * psi[n] + coef[n] * scatter(val[n] at idx[n])  ->  (N, D)."""
    if _plain_or_raise(psi):
        return sparse_axpy_ref(psi, idx, val, coef, rho)
    n, d, k = _check_inputs(psi, idx, val, (("coef", coef), ("rho", rho)))
    out = torch.empty_like(psi)
    lib = _build.load_library()
    fn = getattr(lib, f"sparse_axpy_{_DTYPES[psi.dtype]}")
    code = fn(psi.data_ptr(), idx.data_ptr(), val.data_ptr(), coef.data_ptr(),
              rho.data_ptr(), out.data_ptr(), n, d, k, psi.device.index or 0,
              _stream(psi))
    _build.check(lib, code, "sparse_axpy launch")
    sparse_axpy.launches += 2 if k > 0 else 1
    return out


sparse_axpy.launches = 0
