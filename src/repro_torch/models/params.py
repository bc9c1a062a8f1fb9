"""Parameter definitions (the counterpart of ``repro.models.params``).

A model declares a nested dict of :class:`ParamDef` (shape, logical axes,
initialiser). ``tree_materialize`` draws every leaf on the target device
from one ``torch.Generator``, in chunks along its first axis, so a
full-width model is never built on the host. The logical axes are kept as
documentation of the JAX layout; the port runs on one card and shards
nothing.

The draws are ``torch`` normals: the same seed gives other numbers than
``jax.random``. Tests that compare the two packages build the weights once
(in either package, or with numpy) and carry them over with
``repro_torch.convert.model_params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

_CHUNK_ELEMS = 1 << 27  # at most this many float32 draws in flight per leaf


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate (the ShapeDtypeStruct twin)."""

    shape: tuple[int, ...]
    dtype: Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, logical axes, initialiser and its scale."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def stddev(self) -> float:
        """The normal initialiser's standard deviation."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)

    def materialize(self, generator, dtype, device, storage_dtype=None) -> torch.Tensor:
        """Draw the leaf on `device`.

        Values are ``(stddev * normal).to(dtype)`` as in the JAX package,
        then stored in `storage_dtype` (default `dtype`): a weight that the
        model only ever reads cast to the compute dtype may be stored in
        that dtype at once, which gives the same bits.
        """
        storage_dtype = storage_dtype or dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=storage_dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=storage_dtype, device=device)
        out = torch.empty(self.shape, dtype=storage_dtype, device=device)
        if out.numel() == 0 or out.device.type == "meta":
            return out
        rows = out.view(self.shape[0], -1) if out.ndim > 1 else out.view(-1, 1)
        step = max(1, _CHUNK_ELEMS // max(rows.shape[1], 1))
        for lo in range(0, rows.shape[0], step):
            hi = min(lo + step, rows.shape[0])
            draw = torch.randn((hi - lo, rows.shape[1]), generator=generator,
                               dtype=torch.float32, device=device)
            rows[lo:hi] = (self.stddev * draw).to(dtype).to(storage_dtype)
        return out


def tree_map(fn: Callable, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over nested dicts.

    `path` is the tuple of dict keys leading to the leaf.
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=(*path, k))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_materialize(defs, generator, dtype, device, storage_dtype=None):
    """Materialize every ParamDef in `defs` on `device` from `generator`.

    `storage_dtype` is an optional ``path -> dtype`` rule (None: `dtype`).
    """
    def one(path, d):
        store = storage_dtype(path) if storage_dtype else None
        return d.materialize(generator, dtype, device, store)

    return tree_map(one, defs)


def tree_num_params(defs) -> int:
    """Total element count of a ParamDef tree."""
    return sum(math.prod(d.shape) for d in tree_leaves(defs))
