"""Serving: paged KV cache and continuous-batching scheduler (counterpart of
``repro.serve``).

  cache.py      CachePool: one KV page pool shared by every sequence,
                per-slot block tables, host-side page and slot accounting
  engine.py     generate(): the contiguous-cache prefill + decode loop
  scheduler.py  Scheduler: continuous batching at a fixed max-batch shape
"""
from repro_torch.serve.cache import CachePool, PoolConfig
from repro_torch.serve.engine import GenResult, generate
from repro_torch.serve.scheduler import Request, Scheduler, ServeStats, StepStats

__all__ = [
    "CachePool", "PoolConfig", "GenResult", "generate",
    "Request", "Scheduler", "ServeStats", "StepStats",
]
