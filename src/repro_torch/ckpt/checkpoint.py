"""Checkpointing with atomic commit and async write (counterpart of
``repro.ckpt.checkpoint``), in the same on-disk layout:

  <dir>/step_<N>.tmp/           staged writes
  <dir>/step_<N>/               committed (atomic rename)
      manifest.json             leaf paths + shapes/dtypes + metadata
      arr_<i>.npy               one file per leaf

A tree nests dicts, dataclasses (a solver's ``DSBAState``), tuples and
lists; its leaves are tensors, numpy arrays or numbers, and ``None`` holds
no leaf. Leaves are numbered and named as JAX's ``tree_flatten_with_path``
numbers and names them: dict keys in sorted order (``['key']``), dataclass
fields in declaration order (``.name``), sequence items by index
(``[0]``), a leaf's path being its keys joined by ``/``
(``['params']/['embed']``, ``['state']/.z``, ``['carry']/[0]/.step``). So
a checkpoint written by either package is read by the other, a solver's
as well as a training run's.

Fault-tolerance contract, as in the JAX package:
  * a crash mid-write leaves only a .tmp dir -> ignored on restore
  * restore picks the newest COMMITTED step
  * ``CheckpointManager.save`` copies the tree to the host synchronously,
    then writes on a background thread (the train step updates its tensors
    in place, so the copy must be taken before the next step)
  * keep_last prunes old steps after commit

bfloat16 leaves are written as the JAX package writes them (numpy has no
bfloat16; JAX's comes from ``ml_dtypes``, which the port does not use): an
``.npy`` of the raw 2-byte values with the header's descr ``'<V2'``, and
``"dtype": "bfloat16"`` in the manifest. They are read back bit for bit as
``torch.bfloat16``, from either package's files.

``CheckpointSpec`` is how ``core.solvers.solve(checkpoint=, resume=)``
snapshots a run.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """How ``solve(..., checkpoint=...)`` snapshots a run.

    ``directory``: where the ``step_<N>`` checkpoint dirs go.
    ``every``: checkpoint period in solver ITERATIONS; on the dense
    backend it must be a multiple of ``record_every`` (snapshots happen at
    record boundaries).
    ``keep_last``: how many committed checkpoints to retain.

    ``solve(..., resume=directory)`` restores the newest committed
    checkpoint and continues BIT-EQUAL to an uninterrupted run: solver
    state, recorder contents and the sample-stream position all resume
    exactly (``draw_indices`` fills row-major, so the per-node index
    streams are prefix-stable in ``steps``).
    """

    directory: str | pathlib.Path
    every: int
    keep_last: int = 3

    def __post_init__(self):
        """Validate the checkpoint period."""
        if int(self.every) < 1:
            raise ValueError(f"checkpoint every={self.every} must be >= 1")


def _children(tree):
    """[(path key, child)] of a container, in JAX's flatten order; None
    for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{key!r}]", tree[key]) for key in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", item) for i, item in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix=""):
    """(paths, leaves) of a tree, in JAX's order and with JAX's path names."""
    if tree is None:
        return [], []
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    paths, leaves = [], []
    for key, child in kids:
        p, leaf = _flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
        paths += p
        leaves += leaf
    return paths, leaves


def _unflatten(tree, leaves):
    """A tree shaped like `tree` (a dict's key order too) with the leaves,
    given in flatten order, put in."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {key: build(t[key]) for key in sorted(t)}
            return {key: built[key] for key in t}
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(
                t, **{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})
        if isinstance(t, (tuple, list)):
            return type(t)(build(item) for item in t)
        return next(it)

    return build(tree)


_BF16_RAW = np.dtype("V2")  # a bfloat16 leaf's host copy: its raw 2-byte values


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf (a copy also for CPU tensors and numpy
    arrays: the train step updates its tensors in place); a bfloat16
    tensor's is its raw values, dtype ``V2``."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_RAW)
        return host.numpy()
    return np.array(leaf)


def _save_leaf(path: pathlib.Path, arr: np.ndarray) -> str:
    """Write one host leaf as ``.npy``; its manifest dtype. Raw bfloat16
    values get the header the JAX package's ``np.save`` writes ('<V2')."""
    if arr.dtype != _BF16_RAW:
        np.save(path, arr)
        return str(arr.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())
    return "bfloat16"


def _load_leaf(path: pathlib.Path, dtype: str):
    """One leaf file as numpy, or as a ``torch.bfloat16`` tensor when the
    manifest says bfloat16."""
    arr = np.load(path)
    if dtype != "bfloat16":
        return arr
    if arr.dtype.itemsize != 2:
        raise ValueError(f"{path.name}: a bfloat16 leaf stored as {arr.dtype}")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def save_checkpoint(directory, step: int, tree, *, keep_last: int = 3,
                    metadata: dict | None = None) -> pathlib.Path:
    """Write `tree` as committed step `step` (stage in .tmp, then rename)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    paths, leaves = _flatten_with_paths(tree)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = _to_numpy(leaf)
        dtype = _save_leaf(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append(
            {"path": p, "file": f"arr_{i}.npy", "shape": list(arr.shape), "dtype": dtype}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit

    steps = sorted(committed_steps(directory))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(directory / f"step_{s}", ignore_errors=True)
    return final


def committed_steps(directory) -> list[int]:
    """Sorted steps with a committed checkpoint (a manifest, no .tmp)."""
    directory = pathlib.Path(directory)
    out = []
    if not directory.exists():
        return out
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
    return sorted(out)


def _like(arr, like):
    """`arr` (numpy, or a bfloat16 tensor) as `like`'s kind: a tensor with
    its dtype and device, a host int or float (a solver's step counter),
    else numpy."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, (int, float)) and not isinstance(like, bool):
        return type(like)(arr.item())
    return np.asarray(arr, dtype=getattr(like, "dtype", None))


def restore_checkpoint(directory, tree_like, step: int | None = None):
    """Restore into the structure of `tree_like`. Returns (tree, step) or
    (None, None) when no committed checkpoint exists."""
    directory = pathlib.Path(directory)
    steps = committed_steps(directory)
    if not steps:
        return None, None
    step = steps[-1] if step is None else step
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())

    paths, leaves = _flatten_with_paths(tree_like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    if set(paths) != set(by_path):
        missing = set(paths) ^ set(by_path)
        raise ValueError(f"checkpoint tree mismatch; differing paths: {missing}")
    new_leaves = []
    for p, like in zip(paths, leaves):
        arr = _load_leaf(d / by_path[p]["file"], by_path[p]["dtype"])
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"shape mismatch at {p}: {arr.shape} vs {tuple(np.shape(like))}")
        new_leaves.append(_like(arr, like))
    return _unflatten(tree_like, new_leaves), step


def load_checkpoint(directory, step: int | None = None):
    """Load a committed checkpoint without a template tree.

    Returns ``(step, metadata, {path: np.ndarray})`` for the newest (or
    requested) committed step (a bfloat16 leaf as a ``torch.bfloat16``
    tensor), or ``(None, None, None)`` when the directory holds no
    committed checkpoint.
    """
    directory = pathlib.Path(directory)
    steps = committed_steps(directory)
    if not steps:
        return None, None, None
    step = steps[-1] if step is None else step
    if step not in steps:
        raise ValueError(
            f"no committed checkpoint for step {step} in {directory}; committed: {steps}"
        )
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = {e["path"]: _load_leaf(d / e["file"], e["dtype"]) for e in manifest["leaves"]}
    return step, manifest.get("metadata", {}), leaves


def committed_metadata(directory, step: int | None = None) -> dict | None:
    """The metadata of the newest (or requested) committed checkpoint, read
    from its manifest alone; None when the directory holds none."""
    directory = pathlib.Path(directory)
    steps = committed_steps(directory)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    manifest = json.loads((directory / f"step_{step}" / "manifest.json").read_text())
    return manifest.get("metadata", {})


class CheckpointManager:
    """Async checkpointing: save() stages a host copy and writes on a
    background thread; wait() joins before exit/next save."""

    def __init__(self, directory, keep_last: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, *, metadata=None, async_: bool = True):
        """Commit `tree` as `step`; the host copy is taken before returning."""
        self.wait()
        _, leaves = _flatten_with_paths(tree)
        host_tree = _unflatten(tree, [_to_numpy(leaf) for leaf in leaves])
        if not async_:
            save_checkpoint(self.directory, step, host_tree,
                            keep_last=self.keep_last, metadata=metadata)
            return

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                keep_last=self.keep_last, metadata=metadata)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the pending write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like, step=None):
        """``restore_checkpoint`` after the pending write has landed."""
        self.wait()
        return restore_checkpoint(self.directory, tree_like, step)
