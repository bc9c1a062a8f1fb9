"""Contiguous-cache generation loop (counterpart of ``repro.serve.engine``).

``generate()`` prefills a batch of prompts of one length into a contiguous
cache, then decodes token by token with the same ``decode_step``; the
scheduler owns the paged continuous-batching path. Greedy decoding picks
the argmax, as the JAX package does; temperature sampling draws from a
``torch.Generator`` seeded with `seed`, which gives other tokens than
``jax.random`` from the same seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class GenResult:
    """Tokens plus timing from one generate() call.

    ``logits`` holds the float32 logits of every step: the prefill's, then
    one per decode step (the last step's are sampled from but not kept as
    a token, as in the JAX loop).
    """

    tokens: np.ndarray  # (B, max_new_tokens) int32
    logits: list
    prefill_s: float
    decode_s: float
    prompt_tokens: int
    new_tokens: int

    @property
    def prefill_tok_s(self) -> float:
        """Prompt tokens per second of prefill."""
        return self.prompt_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        """Generated tokens per second of decode."""
        return self.new_tokens / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params: dict, prompts: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             seed: int = 1, enc_embeds: torch.Tensor | None = None) -> GenResult:
    """Prefill prompts (B, P) on their device, then decode max_new_tokens
    greedily (or with temperature sampling). The encdec family needs
    `enc_embeds` (B, encoder_len, d_model): the encoder runs once and its
    cross K/V fill the cache first."""
    B, P = prompts.shape
    dev = prompts.device
    cache = T.init_cache(cfg, B, P + max_new_tokens, dev)
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError("encdec family needs enc_embeds")
        cache["cross"] = T.encode_cross_cache(cfg, params, enc_embeds, B)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def sample(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return torch.argmax(logits, dim=-1, keepdim=True)

    t0 = time.perf_counter()
    cache, logits = T.decode_step(cfg, params, prompts, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out, seen = [], [logits]
    tok = sample(logits)
    t0 = time.perf_counter()
    for _ in range(max_new_tokens):
        out.append(tok)
        cache, logits = T.decode_step(cfg, params, tok, cache)
        seen.append(logits)
        tok = sample(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0

    return GenResult(
        tokens=torch.cat(out, dim=1).to(torch.int32).cpu().numpy(),
        logits=seen,
        prefill_s=prefill_s,
        decode_s=decode_s,
        prompt_tokens=B * P,
        new_tokens=B * max_new_tokens,
    )
