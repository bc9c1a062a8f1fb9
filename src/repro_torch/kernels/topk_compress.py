"""Block-local top-k magnitude selection: the wrapper around ``csrc/topk_compress.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/topk_compress.py``
(``block_topk`` / ``_topk_kernel``), the selection of the gossip step's
sparse wire format (``core/gossip.py::block_topk_compress``): for every row
of x (nb, block) the k entries of largest |x|, as (vals (nb, k) float32,
row-local idx (nb, k) int32), in descending |x| with the lower index
first among equal magnitudes. The kernel's output equals the plain
version's (``ref.block_topk_ref``) bit for bit, values and order both.

Bound on an H100: bytes. At the gossip step's embedding leaf (2 pods x
144,000 rows of 4,096, k = 40) a call reads 4.72 GB and writes 92 MB,
1.44 ms at 3.35 TB/s. The design (one block of 256 threads per row, the
row in registers, k rounds of a block-wide argmax) is simple first; see
the ``.cu`` header.

The wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. It takes
float32, contiguous, 2-D input with ``1 <= k <= block <= MAX_BLOCK``.
``block_topk.launches`` counts kernel launches: one per call with nb > 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_topk_ref

MAX_BLOCK = 8192  # 256 threads x 32 registers each (csrc/topk_compress.cu)


def _check_inputs(x: torch.Tensor, k: int) -> tuple[int, int]:
    """Validate what the kernel takes; returns (nb, block)."""
    if x.dtype != torch.float32:
        raise TypeError(f"block_topk takes float32 rows, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be (nb, block), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    nb, block = x.shape
    if block > MAX_BLOCK:
        raise ValueError(
            f"block={block} exceeds the kernel's limit of {MAX_BLOCK} elements a row "
            "(256 threads x 32 registers)"
        )
    if not 1 <= k <= block:
        raise ValueError(f"k={k} must be in [1, block={block}]")
    return nb, block


def block_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by |value|: (vals (nb, k) float32, idx (nb, k) int32)."""
    if _build.plain_or_raise(x):
        return block_topk_ref(x, k)
    nb, block = _check_inputs(x, k)
    vals = torch.empty((nb, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    if nb == 0:
        return vals, idx
    lib = _build.load_library("topk_compress")
    code = lib.block_topk_f32(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), nb, block, k,
                              x.device.index or 0, _build.stream(x))
    _build.check(lib, code, "block_topk launch")
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0
