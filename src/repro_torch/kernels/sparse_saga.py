"""The DSBA per-node sparse kernels: wrappers around ``csrc/sparse_saga.cu``.

Replaces the Pallas TPU kernels of ``repro/kernels/sparse_saga.py``
(``sparse_dot`` / ``_dot_kernel`` and ``sparse_axpy`` / ``_axpy_kernel``).
There the gather and the scatter are one-hot matrix products, a workaround
for the TPU's missing VMEM gather; on Hopper both are native gathers and
scatters of global memory, so the CUDA kernels index ``psi[n, idx]``
directly.

Bound on an H100 at the main path's shapes (N = 10, D = 47,236, k = 74,
float64): ``sparse_axpy`` moves 2*N*D*8 B (about 7.6 MB, ~2.3 us at
3.35 TB/s) and ``sparse_dot`` about 15 KB. ``sparse_axpy`` is one launch:
each block owns a 16 KB chunk of a node's row, scales it into shared
memory, applies the node's entries that fall in it in k order and writes
it once, so ``psi`` is read once and ``out`` written once with no atomics;
``sparse_dot`` gives each node one warp that walks its k entries 32 at a
time. See the header of the ``.cu`` file for the arithmetic policy
(f64 ``sparse_axpy`` is bit-equal to ``ref.sparse_axpy_ref``). Since a
``solve()`` step is host-bound, the wrappers keep the path to the launch
short: every input is checked in one expression (``_refuse`` names what
failed), entry points are bound once, and the stream handle is read raw.

Each wrapper takes the plain version (``kernels.ref``) for a tensor on the
CPU, and only then; for a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts ``__global__`` launches, so a run can show
that it went through the kernel: one per call of either.

Index contract: ``idx`` is int32 in ``[0, D)``; padded entries are
``idx = 0, val = 0``. Out-of-range indices are skipped by the kernel and
rejected by the plain version's indexing; callers must not rely on either.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sparse_axpy_ref, sparse_dot_ref

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_MAX_GRID_Y = 65535  # sparse_axpy puts the node index on the grid's y axis
_MAX_INT = 2**31 - 1


def _check_inputs(psi, idx, val, vectors=()):
    """Validate what the kernels take; returns (N, D, K).

    Every call checks every input: dtypes, shapes, devices, contiguity and
    the grid limits, first in one expression of cheap attribute reads (the
    launch path of a host-bound step), then, when that fails, one check at
    a time, to raise the error that names the input."""
    shape, ishape = psi.shape, idx.shape
    dev = psi.get_device()
    if (len(shape) == 2 and len(ishape) == 2 and psi.dtype in _DTYPES
            and idx.dtype is torch.int32 and val.dtype is psi.dtype
            and ishape[0] == shape[0] and val.shape == ishape
            and idx.get_device() == dev and val.get_device() == dev
            and psi.is_contiguous() and idx.is_contiguous() and val.is_contiguous()
            and shape[0] <= _MAX_GRID_Y and shape[1] <= _MAX_INT and ishape[1] <= _MAX_INT):
        for _, t in vectors:
            if not (t.dtype is psi.dtype and t.shape == shape[:1] and t.get_device() == dev
                    and t.is_contiguous()):
                break
        else:
            return shape[0], shape[1], ishape[1]
    _refuse(psi, idx, val, vectors)


def _refuse(psi, idx, val, vectors):
    """Raise the error naming what ``_check_inputs`` refused."""
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
    raise ValueError(f"shape (N={n}, D={d}, k={idx.shape[1]}) too large")  # the grid limits


@functools.cache
def _entry(kind: str, dtype: torch.dtype):
    """The library's entry point for (``"dot"`` | ``"axpy"``, dtype), bound
    once (ctypes builds a function object on every attribute lookup of a
    new name)."""
    return getattr(_build.load_library(), f"sparse_{kind}_{_DTYPES[dtype]}")


def sparse_dot(psi: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_k val[n,k] * psi[n, idx[n,k]]  ->  (N,), dtype of psi."""
    if _build.plain_or_raise(psi):
        return sparse_dot_ref(psi, idx, val)
    n, d, k = _check_inputs(psi, idx, val)
    out = torch.empty((n,), dtype=psi.dtype, device=psi.device)
    code = _entry("dot", psi.dtype)(psi.data_ptr(), idx.data_ptr(), val.data_ptr(),
                                    out.data_ptr(), n, d, k, psi.get_device(),
                                    _build.stream(psi))
    if code:
        _build.check(_build.load_library(), code, "sparse_dot launch")
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
    if _build.plain_or_raise(psi):
        return sparse_axpy_ref(psi, idx, val, coef, rho)
    n, d, k = _check_inputs(psi, idx, val, (("coef", coef), ("rho", rho)))
    out = torch.empty_like(psi)
    code = _entry("axpy", psi.dtype)(psi.data_ptr(), idx.data_ptr(), val.data_ptr(),
                                     coef.data_ptr(), rho.data_ptr(), out.data_ptr(), n, d, k,
                                     psi.get_device(), _build.stream(psi))
    if code:
        _build.check(_build.load_library(), code, "sparse_axpy launch")
    sparse_axpy.launches += 1
    return out


sparse_axpy.launches = 0
