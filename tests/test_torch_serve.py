"""The port's serving layer: pool accounting, the scheduler's policy, and
greedy tokens against the JAX package's scheduler.

Policy tests mirror ``tests/test_serve.py`` (page conservation, youngest-
first preemption with restart, the ``max_preempts`` guard, submit
validation, a one-token request finishing at admission) on the port's
``CachePool`` and ``Scheduler``, on the CPU at minitron-8b's ``reduced()``
size, with requests drawn from numpy seeds. The JAX package has no
counterpart of the pool's ``data_ptrs()``: it stands in for its
zero-recompile witness (the pool is allocated once and written in place).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve import CachePool, PoolConfig, Request, Scheduler, generate

_PC = PoolConfig(max_batch=3, block_size=8, n_blocks=24, max_len=32, prompt_pad=16)


def _make(**over):
    cfg = dataclasses.replace(get_reduced("minitron-8b"), **over)
    return cfg, T.init_params(cfg, 0, "cpu")


def _requests(cfg, n, max_new, seed=0, prompt_pad=16):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, prompt_pad - 1))),
                    max_new_tokens=max_new) for i in range(n)]


# ---------------------------------------------------------------------------
# pool accounting
# ---------------------------------------------------------------------------

def _check_pool_invariants(pool):
    held = [p for pages in pool._pages_of for p in pages]
    free = pool._free_pages
    assert 0 not in held, "null page handed out"
    assert 0 not in free, "null page in the free list"
    assert len(set(held)) == len(held), "page double-booked"
    assert len(set(free)) == len(free), "free list duplicate"
    assert sorted(held + free) == list(range(1, pool.pc.n_blocks)), "pages leaked or invented"
    for slot, pages in enumerate(pool._pages_of):
        assert list(pool.table[slot, : len(pages)]) == pages
        assert np.all(pool.table[slot, len(pages):] == 0)


def test_no_page_leak_100_random_episodes():
    """Random admit/grow/evict sequences conserve the page pool exactly."""
    cfg = get_reduced("minitron-8b")
    rng = np.random.default_rng(42)
    for _ in range(100):
        pc = PoolConfig(max_batch=4, block_size=4, n_blocks=int(rng.integers(3, 20)),
                        max_len=32, prompt_pad=8)
        pool = CachePool(cfg, pc, "cpu")
        live: dict[int, int] = {}
        for _ in range(30):
            op = rng.integers(0, 3)
            if op == 0:
                slot = pool.alloc_slot()
                if slot is None:
                    continue
                want = int(rng.integers(1, pc.max_len + 1))
                if pool.ensure(slot, want):
                    live[slot] = want
                else:
                    pool.release(slot)
            elif op == 1 and live:
                slot = int(rng.choice(list(live)))
                want = int(rng.integers(live[slot], pc.max_len + 1))
                if pool.ensure(slot, want):
                    live[slot] = want
            elif op == 2 and live:
                slot = int(rng.choice(list(live)))
                pool.release(slot)
                del live[slot]
            _check_pool_invariants(pool)
        for slot in list(live):
            pool.release(slot)
        _check_pool_invariants(pool)
        assert pool.free_page_count == pc.n_blocks - 1
        assert pool.free_slot_count == pc.max_batch


def test_pool_sizes_and_device_views():
    cfg = get_reduced("minitron-8b")
    pool = CachePool(cfg, _PC, "cpu")
    assert pool.pools["k"].shape == (cfg.n_layers, _PC.n_blocks, _PC.block_size,
                                     cfg.n_kv_heads, cfg.head_dim)
    assert pool.pools["k"].dtype == cfg.compute_dtype
    slot = pool.alloc_slot()
    assert pool.ensure(slot, 9) and pool.pages_needed(9) == 2
    pool.set_length(slot, 9)
    assert pool.device_table().dtype == torch.int32
    assert pool.device_lengths().tolist()[slot] == 9
    with pytest.raises(ValueError, match="max_len"):
        pool.ensure(slot, _PC.max_len + 1)
    with pytest.raises(ValueError, match="prompt_pad"):
        PoolConfig(block_size=8, prompt_pad=12)


# ---------------------------------------------------------------------------
# scheduler policy
# ---------------------------------------------------------------------------

def test_scheduler_runs_continuous_batches_in_place():
    cfg, params = _make()
    pc = PoolConfig(max_batch=4, block_size=4, n_blocks=40, max_len=32, prompt_pad=16)
    sch = Scheduler(cfg, params, pc, device="cpu")
    ptrs = sch.pool.data_ptrs()
    rng = np.random.default_rng(2)
    reqs = [Request(100 + i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(1, 17))),
                    int(rng.integers(1, 8))) for i in range(12)]
    results, stats = sch.run(reqs)
    assert set(results) == {r.rid for r in reqs}
    for r in reqs:
        assert results[r.rid].shape == (r.max_new_tokens,)
        assert results[r.rid].dtype == np.int32
    assert stats.peak_active == pc.max_batch  # batching happened
    assert stats.total_tokens == sum(r.max_new_tokens - 1 for r in reqs)
    assert sch.pool.data_ptrs() == ptrs
    assert sch.pool.free_page_count == pc.n_blocks - 1


def test_submit_validation():
    cfg, params = _make()
    sch = Scheduler(cfg, params, _PC, device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        sch.submit(Request(0, np.zeros(17, np.int64), 4))
    with pytest.raises(ValueError, match="prompt length"):
        sch.submit(Request(0, np.zeros(0, np.int64), 4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sch.submit(Request(0, np.zeros(4, np.int64), 0))


def test_scheduler_refuses_parameters_on_another_device():
    cfg, params = _make()
    params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="move them"):
        Scheduler(cfg, params, _PC, device="cpu")


def test_max_new_tokens_one_finishes_at_admit():
    """The prefill logits already yield one token: no decode step."""
    cfg, params = _make()
    sch = Scheduler(cfg, params, _PC, device="cpu")
    results, stats = sch.run([Request(7, np.arange(5, dtype=np.int64), max_new_tokens=1)])
    assert results[7].shape == (1,)
    assert stats.total_tokens == 0 and stats.decode_steps == 0
    assert sch.pool.free_slot_count == _PC.max_batch


def test_oom_preemption_restarts_victim():
    """A pool too small for all admitted sequences preempts the youngest
    back to the queue, and every request still completes with the tokens
    it would have had alone (greedy: the restart recomputes them)."""
    cfg, params = _make(compute_dtype=torch.float32)
    pc = PoolConfig(max_batch=2, block_size=4, n_blocks=8, max_len=16, prompt_pad=8)
    reqs = [Request(i, np.arange(1 + i, 7 + i, dtype=np.int64), max_new_tokens=10)
            for i in range(2)]
    results, stats = Scheduler(cfg, params, pc, device="cpu").run(reqs)
    assert set(results) == {0, 1}
    assert all(r.shape == (10,) for r in results.values())
    assert stats.preemptions >= 1
    for r in reqs:
        alone, _ = Scheduler(cfg, params, pc, device="cpu").run([r])
        np.testing.assert_array_equal(results[r.rid], alone[r.rid])


def test_preemption_victim_selection_starvation_guard():
    """Youngest-first among non-exempt slots; when every candidate has hit
    max_preempts, oldest-first fallback."""
    cfg, params = _make()
    sch = Scheduler(cfg, params, _PC, max_preempts=1, device="cpu")
    for r in _requests(cfg, 3, max_new=8):
        sch.submit(r)
    sch._admit()
    assert len(sch._admit_order) == 3
    oldest, mid, youngest = sch._admit_order
    y_rid = sch.active[youngest].req.rid

    assert sch._preempt_youngest(protect=oldest)
    assert sch.stats.preempt_counts == {y_rid: 1}
    assert youngest not in sch.active
    assert sch.queue[0].rid == y_rid  # back at the FRONT of the queue

    m_rid = sch.active[mid].req.rid
    sch.stats.preempt_counts[m_rid] = 1
    assert sch._preempt_youngest(protect=-1)
    assert sch.queue[0].rid not in (y_rid, m_rid)
    assert sch.stats.preempt_counts[sch.queue[0].rid] == 1
    assert oldest not in sch.active

    assert sch._preempt_youngest(protect=-1)
    assert sch.stats.preempt_counts[m_rid] == 2  # past the cap via the fallback
    assert not sch.active
    assert not sch._preempt_youngest(protect=-1)


def test_starved_request_completes_in_place():
    """A thrash-prone load: the guard caps per-request preemptions, every
    request completes, and the pool is never reallocated."""
    cfg, params = _make()
    pc = PoolConfig(max_batch=2, block_size=4, n_blocks=8, max_len=16, prompt_pad=8)
    sch = Scheduler(cfg, params, pc, max_preempts=2, device="cpu")
    ptrs = sch.pool.data_ptrs()
    reqs = [Request(i, np.arange(1, 7, dtype=np.int64), max_new_tokens=10) for i in range(4)]
    results, stats = sch.run(reqs)
    assert set(results) == {0, 1, 2, 3}
    assert all(r.shape == (10,) for r in results.values())
    assert stats.preemptions >= 2 and stats.preempt_counts
    assert sch.pool.data_ptrs() == ptrs


def test_one_request_matches_contiguous_generate():
    """The paged path and the contiguous generate() give the same greedy
    tokens and (float32) logits for one request."""
    cfg, params = _make(compute_dtype=torch.float32)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 11)
    seen = []
    sch = Scheduler(cfg, params, _PC, device="cpu")
    inner = sch.decode_fn

    def record(*args):
        pools, logits = inner(*args)
        seen.append(logits[sch._admit_order[0]].clone())
        return pools, logits

    sch.decode_fn = record
    results, _ = sch.run([Request(0, prompt, 6)])
    res = generate(cfg, params, torch.as_tensor(prompt)[None], max_new_tokens=6)
    np.testing.assert_array_equal(results[0], res.tokens[0])
    for got, want in zip(seen, res.logits[1:]):
        np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# against the JAX package's scheduler
# ---------------------------------------------------------------------------

def test_greedy_tokens_equal_jax_scheduler():
    """Same weights, same requests (with admission waits, slots at different
    depths, a one-token request and preemption): the same greedy tokens.

    float32 compute. The JAX scheduler runs its decode through the Pallas
    kernel in interpret mode: its default paged route (the jnp oracle) is
    unsteady on this container (ROADMAP Queue 3)."""
    jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), compute_dtype=jnp.float32,
                               decode_kernel="interpret")
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update(param_dtype=torch.float32, compute_dtype=torch.float32,
                  decode_kernel="auto")
    cfg = ModelConfig(**fields)
    params = model_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")

    sizes = dict(max_batch=3, block_size=4, n_blocks=9, max_len=24, prompt_pad=12)
    rng = np.random.default_rng(11)
    plens, news = [12, 3, 9, 5, 1, 7], [6, 9, 1, 12, 4, 8]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    mine, mstats = Scheduler(cfg, params, PoolConfig(**sizes), device="cpu").run(
        [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))])
    theirs, jstats = JScheduler(jcfg, jparams, JPoolConfig(**sizes)).run(
        [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))])
    assert mstats.preemptions == jstats.preemptions >= 1
    assert sorted(mine) == sorted(theirs)
    for rid in theirs:
        np.testing.assert_array_equal(mine[rid], theirs[rid])
