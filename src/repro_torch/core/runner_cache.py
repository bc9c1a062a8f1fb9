"""Keyed caches of bound solver runners (port of ``repro.core.runner_cache``).

Every experiment in this repo is sweep-shaped: many ``solve()`` calls over a
(lam, alpha, method, seed) grid on one problem shape. PyTorch runs eagerly,
so there is nothing to compile; what a call would otherwise redo is the
setup on the device: copying the dataset to it, building the dense features
the full-operator methods read (378 MB at rcv1 width), SSDA's
factorization, the relay's protocol tables, and binding the step and
read-out closures around them. ``core.solvers`` (the dense runners) and
``core.sparse_comm`` (the relay) build that ONCE per cache key and pass
hyperparameter *values* as call arguments, so every later call on the same
problem shape starts warm.

Keying rules (the JAX package's, plus the device):

* The *caller* builds the key: method name, comm backend, operator family,
  data-array shapes/dtypes, graph edges, a mixing-matrix content
  fingerprint, the *static* hyperparameter structure and the device.
  Hyperparameter values never enter the key: they are runner arguments.
* The device is part of every key (``problem_fingerprint``), so a runner
  holding CPU tensors and one holding CUDA tensors never collide.
* Object-identity components (the dataset) are keyed by ``id()`` with a
  strong reference held in the entry ("guard"), so a recycled ``id`` can
  never alias a live key: if the id matches, it *is* the same object.
  Corollary: datasets are treated as immutable; mutating a dataset's
  arrays IN PLACE keeps its id and silently replays the runner built from
  the pre-edit data (build a new dataset object, or ``clear()``).
* Entries are LRU-bounded (default 32), so long-lived processes sweeping
  many distinct problems do not accumulate device memory without bound;
  ``clear()`` drops every entry and with it every tensor a runner holds.

Stats are per-cache and process-global. ``traces`` counts what a build
binds: the runner's step and read-out closures (the dense runners), the
batched variant of a runner, a relay runner's first sequential use and
its ``("batched", key)`` entry (the JAX package compiles each at its
first call). It is incremented from *inside* the build or that first use
(``note_trace``), never on a later hit, so
tests can assert "second call, new hyperparameter values, zero new traces"
directly (tests/test_torch_runner_cache.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class _Entry:
    """One cached runner: the built value plus its identity guards."""

    guards: tuple
    value: Any


class RunnerCache:
    """A bounded, stats-tracking LRU mapping of runner keys to built runners."""

    def __init__(self, name: str, capacity: int = 32):
        """Create an empty cache. ``name`` labels it in aggregated stats."""
        self.name = name
        self.capacity = capacity
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "traces": 0, "evictions": 0}

    def get_or_build(
        self, key: tuple, guards: tuple, build: Callable[[], Any]
    ) -> Any:
        """Return the cached value for ``key`` or build, insert, and return it.

        ``guards`` are the objects whose ``id()`` participates in ``key``;
        the entry holds them strongly so the ids stay valid for its
        lifetime. A hit requires every guard to be the *same object* as at
        insert time (belt and braces on top of the id keying).
        """
        entry = self._entries.get(key)
        if entry is not None and all(
            a is b for a, b in zip(entry.guards, guards)
        ):
            self._stats["hits"] += 1
            self._entries.move_to_end(key)
            return entry.value
        self._stats["misses"] += 1
        value = build()
        self._entries[key] = _Entry(guards=tuple(guards), value=value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._stats["evictions"] += 1
        return value

    def note_trace(self) -> None:
        """Record one bind. Call from INSIDE a build: it runs only on a
        miss, so this counts what was built, not calls."""
        self._stats["traces"] += 1

    def stats(self) -> dict[str, int]:
        """Copy of {hits, misses, traces, evictions, size}."""
        return dict(self._stats, size=len(self._entries))

    def clear(self) -> None:
        """Drop every entry and zero the stats (tests and benchmarks)."""
        self._entries.clear()
        for k in self._stats:
            self._stats[k] = 0


# The process-global caches: the dense runners of core.solvers.solve /
# solve_many, the relay runners of core.sparse_comm and the sharded
# runners (keyed with a mesh fingerprint; the parent keeps the keys and
# stats, each rank its bound step under the runner's token). Module-level
# so stats survive across solve() calls; separate caches per backend
# guarantee a runner never crosses comm backends.
DENSE = RunnerCache("dense")
SPARSE = RunnerCache("sparse")
SHARDED = RunnerCache("sharded")


def problem_fingerprint(data, operator_spec, graph, w, device) -> tuple:
    """The shared problem-shape component of a runner key.

    One definition for both caches (the dense runners in ``core.solvers``
    and the relay in ``core.sparse_comm``), so the keying schema cannot
    drift between them: dataset identity (guard the object!), padded-CSR
    shapes/dtype, operator family, graph edges, a mixing-matrix content
    fingerprint, and the device the runner's tensors live on.
    """
    return (
        id(data),
        (data.n_nodes, data.q, data.k, data.d,
         str(np.asarray(data.val).dtype)),
        operator_spec,
        (graph.n, tuple(graph.edges)),
        array_fingerprint(w),
        str(device),
    )


def array_fingerprint(a) -> tuple:
    """Content key for a small array (the mixing matrix): shape, dtype, hash.

    Problems rebuilt per sweep point (bench_table1 makes one per ``lam``)
    carry *equal* but not *identical* W arrays; fingerprinting by content
    lets them share one runner.
    """
    a = np.ascontiguousarray(a)
    return (
        a.shape,
        str(a.dtype),
        hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest(),
    )


def fault_fingerprint(
    has_link: bool, has_straggler: bool, n_slots: int = 0
) -> tuple:
    """The fault-structure component of a runner key.

    Only the STRUCTURE of the injected faults enters the key: which
    families are active (and how many straggler buffer slots the step
    threads). The per-step masks are bound per run, so one fault runner
    serves every drop rate and seed, exactly like hyperparameter values. A
    fault-free runner has no ``("faults", ...)`` component at all, so it
    can never collide with a faulty one.
    """
    return ("faults", bool(has_link), bool(has_straggler), int(n_slots))


def mesh_fingerprint(mesh) -> tuple:
    """The mesh component of every sharded runner key: ``(n, device,
    ranks)``, the ranks being the worker processes' ids.

    Two meshes of the same size and device but other workers (a mesh
    rebuilt after ``close``) key distinct runners, since the ranks hold the
    bound steps; a dense runner (no mesh) can never collide with a
    sharded one (separate cache and key schema).
    """
    return (int(mesh.n), mesh.device.type, tuple(mesh.ranks))


def stats() -> dict[str, dict[str, int]]:
    """{cache name: stats} for every runner cache in the process."""
    return {c.name: c.stats() for c in (DENSE, SPARSE, SHARDED)}


def clear() -> None:
    """Reset every runner cache (cold-start benchmarks, test isolation)."""
    DENSE.clear()
    SPARSE.clear()
    SHARDED.clear()
