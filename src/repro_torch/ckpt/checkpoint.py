"""Checkpointing with atomic commit and async write (counterpart of
``repro.ckpt.checkpoint``), in the same on-disk layout:

  <dir>/step_<N>.tmp/           staged writes
  <dir>/step_<N>/               committed (atomic rename)
      manifest.json             leaf paths + shapes/dtypes + metadata
      arr_<i>.npy               one file per leaf

A tree is a nested dict whose leaves are tensors, numpy arrays or numbers.
Leaves are numbered and named as JAX's ``tree_flatten_with_path`` numbers
and names a dict tree: keys in sorted order at every level, and a leaf's
path is its keys as ``['key']`` joined by ``/`` (``['params']/['embed']``).
So a checkpoint written by either package is read by the other.

Fault-tolerance contract, as in the JAX package:
  * a crash mid-write leaves only a .tmp dir -> ignored on restore
  * restore picks the newest COMMITTED step
  * ``CheckpointManager.save`` copies the tree to the host synchronously,
    then writes on a background thread (the train step updates its tensors
    in place, so the copy must be taken before the next step)
  * keep_last prunes old steps after commit

``CheckpointSpec`` and ``solve(checkpoint=, resume=)`` are not ported
(ROADMAP Queue 1 item 9): constructing a ``CheckpointSpec`` raises.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch


class CheckpointSpec:
    """How ``solve(..., checkpoint=...)`` snapshots a run: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CheckpointSpec (solve(checkpoint=, resume=)) is not ported "
            "(ROADMAP Queue 1 item 9)"
        )


def _flatten_with_paths(tree, prefix=""):
    """(paths, leaves) of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        paths, leaves = [], []
        for key in sorted(tree):
            p, leaf = _flatten_with_paths(tree[key], f"{prefix}/[{key!r}]" if prefix
                                          else f"[{key!r}]")
            paths += p
            leaves += leaf
        return paths, leaves
    return [prefix], [tree]


def _unflatten(tree, leaves):
    """A tree shaped like `tree` (its key order too) with the leaves, given
    in flatten order, put in."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {key: build(t[key]) for key in sorted(t)}
            return {key: built[key] for key in t}
        return next(it)

    return build(tree)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf (a copy also for CPU tensors and numpy
    arrays: the train step updates its tensors in place)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; cast them to "
                            "float32 before saving")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


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
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append(
            {"path": p, "file": f"arr_{i}.npy", "shape": list(arr.shape),
             "dtype": str(arr.dtype)}
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


def _like(arr: np.ndarray, like):
    """`arr` as `like`'s kind: a tensor with its dtype and device, else numpy."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
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
        arr = np.load(d / by_path[p]["file"])
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"shape mismatch at {p}: {arr.shape} vs {tuple(np.shape(like))}")
        new_leaves.append(_like(arr, like))
    return _unflatten(tree_like, new_leaves), step


def load_checkpoint(directory, step: int | None = None):
    """Load a committed checkpoint without a template tree.

    Returns ``(step, metadata, {path: np.ndarray})`` for the newest (or
    requested) committed step, or ``(None, None, None)`` when the directory
    holds no committed checkpoint.
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
    leaves = {e["path"]: np.load(d / e["file"]) for e in manifest["leaves"]}
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
