"""Deterministic, resumable, sharded LM token pipeline (a copy of
``repro.data.sharded_loader``: numpy only, so the batches are byte-identical
to the JAX package's for the same (seed, step, shard)).

Design goals (the ones that matter at 1000-node scale):
  * deterministic as a function of (seed, step, shard) — any host can
    reconstruct any batch, so restart-after-failure needs NO data state
    beyond the step counter already in the checkpoint
  * sharded: each (pod, data) slice reads only its shard
  * zero-copy resume: `start_step` fast-forwards by arithmetic, not by
    replaying the stream
  * background prefetch of the next batch

Synthetic token source (no corpus ships with the repo): a seeded PRNG per
(step, shard) cell. Swapping in a real tokenized corpus = replacing
`_cell_tokens` with an indexed read; the determinism contract is unchanged.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    """Vocabulary, global batch, sequence length, shard count and seed."""

    vocab_size: int
    global_batch: int
    seq_len: int
    n_shards: int = 1  # data-parallel shards reading disjoint rows
    seed: int = 0

    @property
    def shard_batch(self) -> int:
        """Rows per shard."""
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class ShardedTokenLoader:
    """One shard's batches from `start_step` on, prefetched on a thread."""

    def __init__(self, cfg: LoaderConfig, shard: int = 0, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.shard = shard
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _cell_tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        return rng.integers(
            0, self.cfg.vocab_size,
            size=(self.cfg.shard_batch, self.cfg.seq_len + 1),
            dtype=np.int32,
        )

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            toks = self._cell_tokens(step)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        """The next batch: {'tokens', 'targets'} (B, S) int32."""
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self):
        """The loader itself."""
        return self

    def close(self):
        """Stop the prefetch thread and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def batch_at(cfg: LoaderConfig, step: int) -> dict:
    """Direct (thread-free) deterministic access: the resume contract."""
    shards = [
        ShardedTokenLoader.__new__(ShardedTokenLoader) for _ in range(cfg.n_shards)
    ]
    rows = []
    for s in range(cfg.n_shards):
        ld = shards[s]
        ld.cfg, ld.shard = cfg, s
        rows.append(ld._cell_tokens(step))
    toks = np.concatenate(rows, axis=0)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
