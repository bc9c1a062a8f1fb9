"""Continuous-batching scheduler over the paged cache pool
(counterpart of ``repro.serve.scheduler``, with the same policy).

Between decode steps the scheduler admits queued requests into free slots
(prefill at a fixed ``(1, prompt_pad)`` shape), evicts finished sequences,
and, when the page pool runs dry mid-decode, preempts the youngest active
sequence back to the queue. Decode runs at the fixed ``(max_batch, 1)``
shape with padding lanes masked by length 0 and null block tables.

Admission: FIFO, while a free slot exists and the pool can cover the
prompt; a request longer than ``prompt_pad`` is rejected at submit.
Preemption restarts the victim from scratch: its generated tokens are
discarded and the request returns to the FRONT of the queue. A request
preempted ``max_preempts`` times is exempt from further preemption
(oldest-first fallback among exempt slots), so no request thrashes forever.

Sampling stays on the host in numpy (``_sample``, greedy or Gumbel-max with
``numpy.random.default_rng(seed)``), as in the JAX package, so the two
produce the same tokens from the same logits.

Everything runs on one device: the card unless ``device`` says otherwise;
the parameters must already be there (the scheduler never moves them).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves
from repro_torch.serve.cache import CachePool, PoolConfig


@dataclasses.dataclass
class Request:
    """One generation request.

    enc_embeds (encoder_len, d_model) is required for the encdec family
    (whisper) and ignored otherwise.
    """

    rid: int
    tokens: np.ndarray  # (prompt_len,) int token ids
    max_new_tokens: int
    enc_embeds: np.ndarray | None = None


@dataclasses.dataclass
class StepStats:
    """Counters for one scheduler step (recorded after admission)."""

    step: int
    queue_depth: int
    active_slots: int
    pool_occupancy: float
    admitted: int
    finished: int
    preempted: int
    tokens_generated: int


@dataclasses.dataclass
class ServeStats:
    """Per-step counter trace for a scheduler run.

    ``preempt_counts`` maps request id -> how many times that request was
    preempted (the starvation guard's witness).
    """

    steps: list[StepStats] = dataclasses.field(default_factory=list)
    preempt_counts: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def total_tokens(self) -> int:
        """Tokens generated by decode steps (prefill's first token excluded)."""
        return sum(s.tokens_generated for s in self.steps)

    @property
    def peak_active(self) -> int:
        """Most slots active in one step."""
        return max((s.active_slots for s in self.steps), default=0)

    @property
    def peak_occupancy(self) -> float:
        """Highest pool occupancy seen."""
        return max((s.pool_occupancy for s in self.steps), default=0.0)

    @property
    def preemptions(self) -> int:
        """Total preemptions."""
        return sum(s.preempted for s in self.steps)

    @property
    def decode_steps(self) -> int:
        """Steps that ran the decode (at least one active slot)."""
        return sum(1 for s in self.steps if s.tokens_generated)


@dataclasses.dataclass
class _Active:
    req: Request
    generated: list[int]
    target: int  # total tokens to generate (capped by pool max_len)


class Scheduler:
    """Continuous batching: fixed-shape decode, dynamic membership.

    ``decode_fn`` is the decode step the scheduler calls,
    ``(params, tokens, pools, table, lengths) -> (pools, logits)``; it is
    ``transformer.decode_step_paged`` for this config, and a harness may
    wrap it (to time it, or to compare kernel modes on the same pool state).
    """

    def __init__(self, cfg: ModelConfig, params: dict, pool_cfg: PoolConfig, *,
                 temperature: float = 0.0, seed: int = 0, max_preempts: int = 3,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"parameters are on {leaf.device}, the scheduler runs on "
                    f"{self.device}: move them first"
                )
        self.pool = CachePool(cfg, pool_cfg, self.device)
        self.temperature = temperature
        self.max_preempts = max_preempts
        self._rng = np.random.default_rng(seed)
        self.queue: deque[Request] = deque()
        self.active: dict[int, _Active] = {}
        self._admit_order: list[int] = []  # slots, oldest admission first
        self._cur_tok = np.zeros((pool_cfg.max_batch, 1), np.int64)
        self.results: dict[int, np.ndarray] = {}
        self.stats = ServeStats()
        self._step_idx = 0
        self.decode_fn = lambda *a: T.decode_step_paged(cfg, *a)

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request; raises on a prompt or budget it cannot serve."""
        plen = len(req.tokens)
        pc = self.pool.pc
        if not 1 <= plen <= pc.prompt_pad:
            raise ValueError(f"prompt length {plen} not in [1, prompt_pad={pc.prompt_pad}]")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.cfg.family == "encdec" and req.enc_embeds is None:
            raise ValueError("encdec requests need enc_embeds")
        self.queue.append(req)

    # -- sampling -----------------------------------------------------------

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature > 0:
            g = self._rng.gumbel(size=logits_row.shape)
            return int(np.argmax(logits_row / self.temperature + g))
        return int(np.argmax(logits_row))

    # -- admission ----------------------------------------------------------

    def _finish(self, slot: int) -> None:
        st = self.active.pop(slot)
        self._admit_order.remove(slot)
        self.results[st.req.rid] = np.asarray(st.generated, np.int32)
        self.pool.release(slot)

    def _admit_one(self) -> bool:
        req = self.queue[0]
        plen = len(req.tokens)
        slot = self.pool.alloc_slot()
        if slot is None:
            return False
        if not self.pool.ensure(slot, plen):
            self.pool.release(slot)  # returns the empty slot
            return False
        self.queue.popleft()
        pc = self.pool.pc

        padded = np.zeros((1, pc.prompt_pad), np.int64)
        padded[0, :plen] = np.asarray(req.tokens)
        cache = T.init_cache(self.cfg, 1, pc.prompt_pad, self.device)
        if self.cfg.family == "encdec":
            enc = torch.as_tensor(np.asarray(req.enc_embeds), device=self.device)[None]
            cache["cross"] = T.encode_cross_cache(self.cfg, self.params, enc, 1)
        cache, logits = T.prefill(
            self.cfg, self.params, torch.as_tensor(padded, device=self.device), cache,
            valid_len=torch.tensor([plen], dtype=torch.int32, device=self.device),
        )
        self.pool.write_prefill(slot, cache)
        self.pool.set_length(slot, plen)

        # the prefill logits already yield the first generated token: a
        # decode step per NEW token, not per request token
        g0 = self._sample(logits[0].cpu().numpy())
        target = min(req.max_new_tokens, pc.max_len - plen + 1)
        st = _Active(req, [g0], target)
        if target <= 1:
            self.results[req.rid] = np.asarray(st.generated, np.int32)
            self.pool.release(slot)
            return True
        self.active[slot] = st
        self._admit_order.append(slot)
        self._cur_tok[slot, 0] = g0
        return True

    def _admit(self) -> int:
        admitted = 0
        while self.queue and self._admit_one():
            admitted += 1
        return admitted

    # -- preemption ---------------------------------------------------------

    def _preempt_youngest(self, protect: int) -> bool:
        """Evict an active slot (except `protect`) back to the queue front,
        discarding its progress: youngest-first over slots not yet preempted
        ``max_preempts`` times, else the oldest candidate."""
        candidates = [s for s in self._admit_order if s != protect]
        victim = next(
            (s for s in reversed(candidates)
             if self.stats.preempt_counts.get(self.active[s].req.rid, 0) < self.max_preempts),
            candidates[0] if candidates else None,
        )
        if victim is None:
            return False
        st = self.active.pop(victim)
        self._admit_order.remove(victim)
        self.pool.release(victim)
        self._cur_tok[victim, 0] = 0
        self.queue.appendleft(st.req)
        rid = st.req.rid
        self.stats.preempt_counts[rid] = self.stats.preempt_counts.get(rid, 0) + 1
        return True

    def _ensure_capacity(self) -> int:
        """Every active slot gets a page for this step's K/V write,
        preempting youngest-first when the pool runs dry."""
        preempted = 0
        for slot in list(self._admit_order):
            if slot not in self.active:
                continue
            need = int(self.pool.lengths[slot]) + 1
            while not self.pool.ensure(slot, need):
                if not self._preempt_youngest(protect=slot):
                    raise RuntimeError(
                        "page pool too small for a single sequence: "
                        f"slot {slot} needs {need} tokens, "
                        f"{self.pool.free_page_count} pages free"
                    )
                preempted += 1
        return preempted

    # -- the step -----------------------------------------------------------

    def step(self) -> StepStats:
        """Admit, ensure capacity (preempting if needed), decode one token
        for every active slot, evict finished sequences."""
        admitted = self._admit()
        preempted = self._ensure_capacity()
        finished = 0
        tokens_generated = 0

        if self.active:
            _, logits = self.decode_fn(
                self.params,
                torch.as_tensor(self._cur_tok, device=self.device),
                self.pool.pools,
                self.pool.device_table(),
                self.pool.device_lengths(),
            )
            logits_np = logits.cpu().numpy()
            slots = list(self._admit_order)
            self.pool.bump_lengths(slots)
            for slot in slots:
                st = self.active[slot]
                nxt = self._sample(logits_np[slot])
                st.generated.append(nxt)
                self._cur_tok[slot, 0] = nxt
                tokens_generated += 1
                if len(st.generated) >= st.target:
                    self._finish(slot)
                    finished += 1

        stats = StepStats(
            step=self._step_idx,
            queue_depth=len(self.queue),
            active_slots=len(self.active),
            pool_occupancy=self.pool.occupancy(),
            admitted=admitted,
            finished=finished,
            preempted=preempted,
            tokens_generated=tokens_generated,
        )
        self.stats.steps.append(stats)
        self._step_idx += 1
        return stats

    def run(self, requests: list[Request] | None = None, *,
            max_steps: int | None = None) -> tuple[dict[int, np.ndarray], ServeStats]:
        """Drain the queue: step until every request completes.

        Returns ({rid: generated token ids}, per-step ServeStats).
        """
        for req in requests or ():
            self.submit(req)
        limit = max_steps if max_steps is not None else 100_000
        steps = 0
        while (self.queue or self.active) and steps < limit:
            self.step()
            steps += 1
        if self.queue or self.active:
            raise RuntimeError(f"scheduler did not drain in {limit} steps")
        return self.results, self.stats
