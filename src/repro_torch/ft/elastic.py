"""Fault tolerance for decentralized pod-level training (counterpart of
``repro.ft.elastic``).

Decentralized methods have no global barrier, so a pod's failure degrades
the run locally instead of stalling it. The control-plane pieces, simulated
in one process as the pods are:

  HeartbeatMonitor        failure detector: a pod missing ``timeout`` ticks
                          is declared dead, once.
  ElasticGossip           elastic membership: on a pod's death or join,
                          rebuild the mixing graph over the members and
                          remap the gossip state (drop or seed the pod
                          rows); DSBA continues on the new W.
  BoundedStalenessBuffer  straggler mitigation: a late neighbour's last
                          delivered value is reused for up to
                          ``max_staleness`` rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.gossip import GossipConfig


class HeartbeatMonitor:
    """Tick-based failure detector over pods 0..n_pods-1."""

    def __init__(self, n_pods: int, timeout: int = 3):
        self.timeout = timeout
        self.last_seen = {p: 0 for p in range(n_pods)}
        self.tick_now = 0
        self.declared_dead: set[int] = set()

    def heartbeat(self, pod: int):
        """Record a heartbeat of `pod` now (a live heartbeat resurrects it)."""
        self.last_seen[pod] = self.tick_now
        self.declared_dead.discard(pod)

    def tick(self) -> list[int]:
        """Advance time; returns the pods declared dead *this* tick.

        Each death is reported exactly once: a pod stays in `last_seen` (so
        a late heartbeat can resurrect it) but moves into `declared_dead`
        so later ticks stop reporting it.
        """
        self.tick_now += 1
        dead = [
            p for p, t in self.last_seen.items()
            if self.tick_now - t >= self.timeout and p not in self.declared_dead
        ]
        self.declared_dead.update(dead)
        return dead

    def remove(self, pod: int):
        """Stop monitoring `pod`; KeyError if it is not monitored (a silent
        no-op would mask a supervisor's double shrink)."""
        if pod not in self.last_seen:
            raise KeyError(f"pod {pod} is not monitored; known: {sorted(self.last_seen)}")
        del self.last_seen[pod]
        self.declared_dead.discard(pod)

    def add(self, pod: int):
        """Start monitoring `pod` as of now; ValueError if it is already
        monitored (``heartbeat`` refreshes, ``remove`` + ``add`` re-registers)."""
        if pod in self.last_seen:
            raise ValueError(
                f"pod {pod} is already monitored; heartbeat() refreshes it, remove() + "
                "add() re-registers it"
            )
        self.last_seen[pod] = self.tick_now
        self.declared_dead.discard(pod)


def _pod_leaf(x, n: int) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == n


def _map_leaves(fn: Callable, tree):
    """``fn`` over every leaf of nested dicts, dataclasses, tuples and lists.

    The containers JAX's ``tree_map`` walks for a solver state: a dict's
    values, a dataclass's fields (``DSBAState``), a tuple's or list's items
    (the other solvers' states). Anything else is a leaf, host ints and
    0-d step counters included.
    """
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class ElasticGossip:
    """Membership + state remapping for the pod axis."""

    gc: GossipConfig

    def shrink(self, state, dead: list[int]) -> tuple[object, GossipConfig]:
        """Drop the dead pods' rows of every per-pod leaf (new tensors);
        the mixing is rebuilt over the survivors by the new config. The
        state is any tree ``_map_leaves`` walks (a gossip dict, a solver's
        dataclass or tuple)."""
        n = self.gc.n_pods
        keep = [p for p in range(n) if p not in dead]
        new_gc = dataclasses.replace(self.gc, n_pods=len(keep))

        def slice_pod(x):
            if _pod_leaf(x, n):
                return x[torch.as_tensor(keep, device=x.device)]
            return x

        return _map_leaves(slice_pod, state), new_gc

    def grow(self, state, n_new: int, seed_from: int = 0) -> tuple[object, GossipConfig]:
        """Join `n_new` pods seeded from pod `seed_from` (a consensus warm
        start); the mixing pulls them into agreement."""
        n = self.gc.n_pods
        new_gc = dataclasses.replace(self.gc, n_pods=n + n_new)

        def pad_pod(x):
            if _pod_leaf(x, n):
                seed_rows = x[seed_from].unsqueeze(0).expand(n_new, *x.shape[1:])
                return torch.cat([x, seed_rows], dim=0)
            return x

        return _map_leaves(pad_pod, state), new_gc


@dataclasses.dataclass
class BoundedStalenessBuffer:
    """Per-neighbour last-delivered values with their ages.

    ``get(neighbor)`` returns the freshest delivered value if it is at most
    `max_staleness` rounds old; otherwise None, and the caller drops that
    neighbour's term this round (renormalising the weights).
    """

    max_staleness: int

    def __post_init__(self):
        self._buf: dict[int, tuple[int, object]] = {}
        self._round = 0

    def deliver(self, neighbor: int, value):
        """Store `value` as `neighbor`'s delivery this round."""
        self._buf[neighbor] = (self._round, value)

    def advance(self):
        """Start the next round."""
        self._round += 1

    def get(self, neighbor: int):
        """`neighbor`'s last value if fresh enough, else None."""
        if neighbor not in self._buf:
            return None
        t, v = self._buf[neighbor]
        if self._round - t > self.max_staleness:
            return None
        return v
