"""Paged KV cache: a shared page pool with per-slot block tables
(counterpart of ``repro.serve.cache``).

Device memory for attention K/V is one pool of
``(n_layers, n_blocks, block_size, KV, Dh)`` pages (see
``transformer.paged_cache_defs``). A sequence occupies a *slot*
(0..max_batch) and references pages through a host-side
``(max_batch, n_pages)`` block table, so pool memory scales with live
tokens, not ``max_batch * max_len``.

Page 0 is the reserved **null page**: it is never handed out, inactive
slots point every table entry at it, and prefill scatters pad blocks into
it. Reads through it are masked by length.

The pool tensors are allocated once and updated **in place**: prefill
blocks land by indexed assignment here, and each decode step writes its
new K/V into them (``layers.paged_attention``). The JAX pool is functional
(``.at[].set``) and its ``TracedJit`` wrappers count compilations to show
that the warm loop never recompiles; PyTorch runs eagerly and has nothing
to recompile. What stands in for that witness: ``data_ptrs()`` does not
change across steps (the pool is never reallocated), and the kernels'
launch counts equal what the code predicts.

State whose size does not depend on the length, the ssm family's
recurrent state and conv history, is not paged: it lives in per-slot
tensors indexed by slot id (``transformer.paged_cache_defs``), the pool
hands out no pages for it (``paged`` is False), and ``write_prefill``
overwrites the slot's rows in place. A released slot keeps its stale state
until the next prefill into it overwrites it, as in the JAX package. The
hybrid family's pools nest both kinds, ``{"ssm": {"state", "conv"},
"attn": {"k", "v"}}``: per-slot ssm state beside the pages of its shared
attention block, so it is paged. The encdec family's pools are
``{"self": {"k", "v"}, "cross": {"k", "v"}}``: the decoder's K/V pages and
each slot's encoder K/V (its length is fixed), which ``write_prefill``
overwrites at admission and ``release`` leaves as they are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Sizing for a CachePool.

    max_batch   scheduler slots (fixed decode batch shape)
    block_size  tokens per KV page
    n_blocks    total pages in the pool, INCLUDING the reserved null
                page 0 (so n_blocks - 1 are allocatable)
    max_len     per-sequence token capacity (prompt + generated)
    prompt_pad  fixed padded prompt length for prefill; a multiple of
                block_size so prompt K/V tiles onto pages
    """

    max_batch: int = 8
    block_size: int = 16
    n_blocks: int = 64
    max_len: int = 128
    prompt_pad: int = 32

    def __post_init__(self):
        if self.prompt_pad % self.block_size != 0:
            raise ValueError("prompt_pad must be a multiple of block_size")
        if self.max_len < self.prompt_pad:
            raise ValueError("max_len must cover prompt_pad")
        if self.n_blocks < 2:
            raise ValueError("need at least the null page + one real page")

    @property
    def n_pages(self) -> int:
        """Block-table width: pages needed to cover max_len tokens."""
        return -(-self.max_len // self.block_size)


def _scatter_blocks(pool: torch.Tensor, vals: torch.Tensor, page_ids: torch.Tensor) -> None:
    """Write a contiguous (n, P, KV, Dh) K/V slab into pool pages, in place.

    page_ids has P // block_size entries; entries equal to 0 dump their
    (pad) block into the null page, the only place where an index repeats.
    """
    n, P = vals.shape[0], vals.shape[1]
    bs = pool.shape[2]
    blocks = vals.reshape(n, P // bs, bs, *vals.shape[2:])
    pool[:, page_ids] = blocks.to(pool.dtype)


# the nested pools: (the per-slot rows, the K/V pages)
_SPLIT = {"hybrid": ("ssm", "attn"), "encdec": ("cross", "self")}


class CachePool:
    """Page pool + block tables + slot accounting for one served model.

    Host side: free-page and free-slot lists, the block table and per-slot
    lengths (numpy). Device side: the pool tensors, allocated once.

    Typical life of a sequence:
        slot = pool.alloc_slot()
        pool.ensure(slot, prompt_len)        # pages for the prompt
        pool.write_prefill(slot, cache)      # land prefill K/V
        pool.set_length(slot, prompt_len)
        ... per decode step: pool.ensure(slot, length + 1) ...
        pool.release(slot)                   # pages back to the free list
    """

    def __init__(self, cfg: ModelConfig, pc: PoolConfig, device=None):
        self.cfg = cfg
        self.pc = pc
        self.device = resolve_device(device)
        self.n_pages = pc.n_pages
        self.pools = tree_map(
            lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            T.paged_cache_defs(cfg, pc.max_batch, pc.n_blocks, pc.block_size, self.n_pages),
        )
        # an attention-free family (ssm) never takes a page; its null table
        # still feeds decode_step_paged's (unread) arguments
        self.paged = cfg.family != "ssm"
        self.table = np.zeros((pc.max_batch, self.n_pages), np.int32)
        self.lengths = np.zeros((pc.max_batch,), np.int32)
        self._pages_of: list[list[int]] = [[] for _ in range(pc.max_batch)]
        self._free_pages = list(range(pc.n_blocks - 1, 0, -1))  # 0 = null
        self._free_slots = list(range(pc.max_batch - 1, -1, -1))
        self._dirty = True
        self._table_dev = None
        self._lengths_dev = None

    # -- accounting ---------------------------------------------------------

    @property
    def free_page_count(self) -> int:
        """Pages on the free list."""
        return len(self._free_pages)

    @property
    def used_page_count(self) -> int:
        """Allocatable pages held by slots."""
        return (self.pc.n_blocks - 1) - len(self._free_pages)

    @property
    def free_slot_count(self) -> int:
        """Slots not holding a sequence."""
        return len(self._free_slots)

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently held by slots."""
        denom = self.pc.n_blocks - 1
        return self.used_page_count / denom if denom else 0.0

    def data_ptrs(self) -> dict:
        """Device addresses of the pool tensors (they never change), laid
        out as the pools (nested for the hybrid)."""
        return tree_map(lambda _, t: t.data_ptr(), self.pools)

    def pages_needed(self, n_tokens: int) -> int:
        """Pages that cover n_tokens tokens (none for an unpaged family)."""
        if not self.paged:
            return 0
        return -(-n_tokens // self.pc.block_size)

    # -- slot / page lifecycle ----------------------------------------------

    def alloc_slot(self) -> int | None:
        """Claim a free scheduler slot (or None if the batch is full)."""
        if not self._free_slots:
            return None
        return self._free_slots.pop()

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow slot's page allocation to cover n_tokens; False on OOM.

        On failure nothing changes: the caller preempts a victim and
        retries, or gives up.
        """
        if n_tokens > self.pc.max_len:
            raise ValueError(f"n_tokens={n_tokens} exceeds max_len={self.pc.max_len}")
        need = self.pages_needed(n_tokens) - len(self._pages_of[slot])
        if need <= 0:
            return True
        if need > len(self._free_pages):
            return False
        for _ in range(need):
            page = self._free_pages.pop()
            self.table[slot, len(self._pages_of[slot])] = page
            self._pages_of[slot].append(page)
        self._dirty = True
        return True

    def release(self, slot: int) -> None:
        """Return slot's pages to the free list and reset its table row.

        Per-slot state (ssm state and conv, encdec cross K/V) is not zeroed:
        the next write_prefill into this slot overwrites it entirely."""
        self._free_pages.extend(reversed(self._pages_of[slot]))
        self._pages_of[slot] = []
        self.table[slot, :] = 0
        self.lengths[slot] = 0
        self._free_slots.append(slot)
        self._dirty = True

    def set_length(self, slot: int, n_tokens: int) -> None:
        """Set the number of tokens cached for slot."""
        self.lengths[slot] = n_tokens
        self._dirty = True

    def bump_lengths(self, slots: list[int]) -> None:
        """Advance lengths after a decode step appended one token per slot."""
        for s in slots:
            self.lengths[s] += 1
        self._dirty = True

    # -- device views -------------------------------------------------------

    def device_table(self) -> torch.Tensor:
        """The block table on the pool's device (int32)."""
        self._refresh()
        return self._table_dev

    def device_lengths(self) -> torch.Tensor:
        """The per-slot lengths on the pool's device (int32)."""
        self._refresh()
        return self._lengths_dev

    def _refresh(self) -> None:
        if self._dirty or self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table, device=self.device)
            self._lengths_dev = torch.as_tensor(self.lengths, device=self.device)
            self._dirty = False

    # -- landing prefill results --------------------------------------------

    def _prompt_page_ids(self, slot: int) -> torch.Tensor:
        """Page ids for the prompt_pad // block_size prefill blocks; blocks
        past the slot's allocation (prompt padding) target the null page."""
        n_prompt = self.pc.prompt_pad // self.pc.block_size
        ids = np.zeros((n_prompt,), np.int64)
        own = self._pages_of[slot][:n_prompt]
        ids[: len(own)] = own
        return torch.as_tensor(ids, device=self.device)

    def write_prefill(self, slot: int, cache: dict) -> None:
        """Land a batch-1 contiguous prefill cache in the pool, in place.

        `cache` comes from ``transformer.prefill`` at shape (1, prompt_pad).
        Dense and moe K/V slabs are scattered onto the slot's pages; ssm
        state and conv history overwrite row `slot` (never added to it);
        the hybrid does both (its ``"ssm"`` rows, its ``"attn"`` K/V), and
        so does the encdec (its ``"cross"`` K/V rows, its ``"self"`` K/V).
        Call ``set_length`` afterwards with the TRUE prompt length (pad
        blocks land in the null page; pad positions inside the last valid
        block are masked by length).
        """
        fam = self.cfg.family
        if fam in ("hybrid", "encdec"):
            rows_at, pages = _SPLIT[fam]
            states, kv = self.pools[rows_at], self.pools[pages]
            state_src, kv_src = cache[rows_at], cache[pages]
        else:
            states = kv = self.pools
            state_src = kv_src = cache
        if fam in ("ssm", "hybrid", "encdec"):
            for name in states:
                states[name][:, slot] = state_src[name][:, 0].to(states[name].dtype)
        if not self.paged:
            return
        ids = self._prompt_page_ids(slot)
        for name in ("k", "v"):
            _scatter_blocks(kv[name], kv_src[name][:, 0], ids)

    # -- parity helper ------------------------------------------------------

    def gather_kv(self, slot: int, n_tokens: int) -> dict:
        """Slot's K/V as contiguous (n_layers, n_tokens, KV, Dh) numpy arrays
        (the dense and moe families' pages; the JAX package reads back no
        other family's, so the ssm, hybrid and encdec families raise)."""
        if self.cfg.family not in ("dense", "moe"):
            raise ValueError(f"the {self.cfg.family} family has no K/V pages that "
                             "gather_kv reads back")
        pages = self._pages_of[slot]
        out = {}
        for name, pool in self.pools.items():
            slab = pool[:, pages].float().cpu().numpy()  # (n, P, bs, KV, Dh)
            slab = slab.reshape(slab.shape[0], len(pages) * self.pc.block_size, *slab.shape[3:])
            out[name] = slab[:, :n_tokens]
        return out
