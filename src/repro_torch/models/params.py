"""Parameter definitions (the counterpart of ``repro.models.params``).

A model declares a nested dict of :class:`ParamDef` (shape, logical axes,
initialiser). ``tree_materialize`` draws every leaf on the target device
from one ``torch.Generator``, in chunks along its first axis, so a
full-width model is never built on the host.

The logical axes map to mesh axes by ``LOGICAL_RULES`` (a copy of the JAX
package's): FSDP over ``"data"``, TP over ``"model"``. ``ParamDef.pspec``
and ``tree_pspecs`` give each leaf's layout as a ``PartitionSpec`` (a tuple
of mesh axis names or None, one a dimension; the port imports no jax),
``shardable_pspecs`` drops an axis that does not divide its dimension, as
the JAX function does, and ``shard_index`` is a rank's slice of a leaf: the
index JAX gives the device at those mesh coordinates. One card (no mesh)
shards nothing.

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

LOGICAL_RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "ssm_inner": "model",
    "layers": None,
    None: None,
}


class PartitionSpec(tuple):
    """A leaf's layout on a mesh: one entry a dimension, each a mesh axis
    name, a tuple of them (split over their product, the first major) or
    None (not split); the ``jax.sharding.PartitionSpec`` twin, equal to the
    plain tuple of its entries. A tuple of one name is that name, as JAX
    normalises it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, (tuple, list)) and len(a) == 1
                                     else tuple(a) if isinstance(a, list) else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


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

    def pspec(self, rules=None) -> PartitionSpec:
        """The leaf's layout by `rules` (default ``LOGICAL_RULES``)."""
        rules = rules or LOGICAL_RULES
        return P(*(rules.get(a) for a in self.axes))

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


def tree_pspecs(defs, rules=None):
    """The PartitionSpec of every ParamDef of `defs`."""
    return tree_map(lambda _, d: d.pspec(rules), defs)


def _axis_size(ax, mesh_shape) -> int:
    """Ranks along mesh axis `ax` (a name or a tuple of names)."""
    if isinstance(ax, (tuple, list)):
        return math.prod(mesh_shape[a] for a in ax)
    return mesh_shape[ax]


def shardable_pspecs(spec_tree, spec_sds_tree, mesh_shape):
    """Drop the mesh axes that do not evenly divide their dimension (the JAX
    function: small models on wide meshes, whisper's vocab of 51,865, kv
    heads on a wide model axis, leave those dimensions unsplit).

    `spec_sds_tree` holds the leaves' shapes (``TensorSpec`` or anything
    with ``.shape``); `mesh_shape` maps each axis name to its size (a mesh's
    ``shape``)."""
    def fix(_, spec, sds):
        if spec is None:
            return spec
        entries = list(spec) + [None] * (len(sds.shape) - len(spec))
        return P(*(ax if ax is not None and dim % _axis_size(ax, mesh_shape) == 0 else None
                   for dim, ax in zip(sds.shape, entries)))

    return tree_map(fix, spec_tree, spec_sds_tree)


def shard_index(spec, shape, coords, mesh_shape) -> tuple[slice, ...]:
    """The slice of a leaf of `shape` laid out by `spec` that the rank at
    mesh `coords` ({axis: index}) holds: along a split dimension, block
    ``i`` of ``n`` equal blocks (i and n over a tuple of axes: row-major in
    its order); whole (``slice(None)``) elsewhere and over an axis of one
    rank. ``addressable_shards[k].index`` of the device at those
    coordinates in the JAX package."""
    out = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(slice(None))
            continue
        names = ax if isinstance(ax, (tuple, list)) else (ax,)
        i = 0
        for a in names:
            i = i * mesh_shape[a] + coords[a]
        n = _axis_size(ax, mesh_shape)
        if n == 1:  # an axis of one rank splits nothing
            out.append(slice(None))
            continue
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {ax} ({n} ranks)")
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)
