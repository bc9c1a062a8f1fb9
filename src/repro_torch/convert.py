"""Carry datasets, solver states and model weights between the JAX package
and the port.

The port never imports JAX: the caller turns a JAX ``DSBAState`` into
numpy (``{field: np.asarray(leaf)}``) and hands it here, so both packages
can start from one state. ``dataset_to_torch`` moves a ``SparseDataset``
(numpy, from either package's ``data.synthetic``) onto a device once.
``model_params_from_numpy`` does the same for a model's weights: the JAX
``model_defs`` tree with numpy leaves (layers stacked on axis 0 under
``blocks``; the hybrid's one ``shared_attn`` block unstacked beside them)
becomes the port's parameters, each leaf in the dtype the port
holds it in (``transformer.storage_dtype``); ``model_params_to_numpy``
goes back. ``gossip_state_from_numpy`` / ``gossip_state_to_numpy`` carry a
whole pod-axis gossip state (params, opt, params_prev, g_prev, recon,
step) across, every leaf a fresh copy.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_map


@dataclasses.dataclass(frozen=True)
class TensorDataset:
    """A ``SparseDataset`` on a device: padded-CSR rows split over N nodes.

    ``derived`` holds device arrays a run builds from the data once and
    shares between a solver's factories (the dense features, SSDA's
    factorization); ``solve()`` makes one ``TensorDataset`` a run.
    """

    idx: torch.Tensor  # (N, q, k) int32
    val: torch.Tensor  # (N, q, k) float
    y: torch.Tensor  # (N, q) float
    d: int
    derived: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def dataset_to_torch(data, device=None) -> TensorDataset:
    """Copy a numpy ``SparseDataset`` to `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    return TensorDataset(
        idx=torch.as_tensor(np.asarray(data.idx, np.int32), device=dev),
        val=torch.as_tensor(np.asarray(data.val), device=dev),
        y=torch.as_tensor(np.asarray(data.y), device=dev),
        d=int(data.d),
    )


def state_from_numpy(leaves: Mapping[str, np.ndarray], device=None):
    """Build a port ``DSBAState`` from ``{field name: numpy array}``."""
    # imported here: core.solvers imports this module, so a module-level
    # import of core made `import repro_torch.convert` fail when it came first
    from repro_torch.core.dsba import DSBAState

    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(DSBAState)]
    missing = sorted(set(names) - set(leaves))
    if missing:
        raise ValueError(f"state leaves are missing {missing}")
    return DSBAState(**{
        n: torch.as_tensor(np.array(leaves[n]), device=dev) for n in names
    })


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """``{field name: numpy array}`` of a port ``DSBAState`` (copied to host)."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }


def model_params_from_numpy(cfg, tree: Mapping, device=None) -> dict:
    """The port's parameters from a nested dict of numpy arrays.

    The tree must have exactly the leaves of ``transformer.model_defs(cfg)``
    with their shapes. Each leaf is cast as the JAX package casts it at use:
    a float32 leaf becomes ``param_dtype`` (as ``tree_materialize`` stored
    it), then the dtype the port holds it in.
    """
    dev = resolve_device(device)
    store = T.storage_dtype(cfg)

    def one(path, d, arr):
        arr = np.asarray(arr)
        if arr.shape != d.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {d.shape}")
        t = torch.as_tensor(np.require(arr, requirements="W"), device=dev).to(cfg.param_dtype)
        return t.to(store(path))

    defs = T.model_defs(cfg)
    _same_keys(defs, tree)
    return tree_map(one, defs, tree)


def model_params_to_numpy(params: Mapping) -> dict:
    """Nested dict of numpy arrays (float32 for bf16 leaves) of port parameters."""
    def one(_, t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, dict(params))


def gossip_state_from_numpy(cfg, gc, tree: Mapping, device=None) -> dict:
    """A port gossip state (``core.gossip``) from a nested dict of numpy
    arrays, e.g. a JAX ``init_gossip_state`` tree through ``np.asarray``.

    The tree must have exactly the leaves of
    ``gossip_state_defs(cfg, tc, gc)`` for some optimizer (``opt`` holds
    ``mu`` and, unless sgdm, ``nu``) and their shapes. Every leaf is
    copied (so leaves that are one array in the JAX tree, params and
    params_prev at init, become separate tensors: the dsba step writes in
    place) and held in the spec's dtype; ``step`` becomes a 0-d int32
    tensor on the host, as ``init_gossip_state`` makes it.
    """
    from repro_torch.core.gossip import gossip_state_defs
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.step import TrainConfig

    dev = resolve_device(device)
    kind = "adamw" if "nu" in tree.get("opt", {}) else "sgdm"
    defs = gossip_state_defs(cfg, TrainConfig(optimizer=AdamConfig(kind=kind)), gc)
    _same_keys(defs, tree)

    def one(path, spec, arr):
        arr = np.array(arr)  # a copy
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {tuple(spec.shape)}")
        t = torch.as_tensor(arr).to(spec.dtype)
        return t if path == ("step",) else t.to(dev)

    return tree_map(one, defs, tree)


def gossip_state_to_numpy(state: Mapping) -> dict:
    """Nested dict of numpy arrays (host copies) of a port gossip state."""
    return tree_map(lambda _, t: t.detach().to("cpu", copy=True).numpy(), dict(state))


def _same_keys(defs, tree, path=()):
    if isinstance(defs, dict):
        if not isinstance(tree, Mapping) or set(defs) != set(tree):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {got} != {sorted(defs)}")
        for k in defs:
            _same_keys(defs[k], tree[k], (*path, k))
