"""Configurations: the paper's experiments and the model registry.

``dsba_paper`` is a copy of ``repro.configs.dsba_paper``. The model
registry mirrors ``repro.configs``: ``--arch <id>`` (or an alias with
dashes and dots) selects a module exposing ``CONFIG`` (the assigned
configuration) and ``reduced()`` (a small same-family configuration for CPU
tests). ``minitron_8b``, ``gemma2_2b`` and ``mamba2_1p3b`` are ported; every
other id raises ``NotImplementedError`` naming the ROADMAP item that ports
its family, and never falls back to another model.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "minitron_8b",
    "gemma2_2b",
    "qwen2_72b",
    "llama3_405b",
    "zamba2_1p2b",
    "whisper_small",
    "kimi_k2",
    "qwen2_moe",
    "chameleon_34b",
    "mamba2_1p3b",
]

ALIASES = {
    "minitron-8b": "minitron_8b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-72b": "qwen2_72b",
    "llama3-405b": "llama3_405b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-small": "whisper_small",
    "kimi-k2-1t-a32b": "kimi_k2",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "chameleon-34b": "chameleon_34b",
    "mamba2-1.3b": "mamba2_1p3b",
}

PORTED = ("minitron_8b", "gemma2_2b", "mamba2_1p3b")

# where each unported arch id waits (ROADMAP Queue 1 item 12: models)
NOT_PORTED = {
    "qwen2_72b": "dense family with qkv bias: the config is not ported yet",
    "llama3_405b": "dense family at 405B: the config is not ported yet",
    "chameleon_34b": "dense family (fused VLM vocab): the config is not ported yet",
    "zamba2_1p2b": "hybrid family (Mamba2 + shared attention) is not ported",
    "whisper_small": "encdec family is not ported",
    "kimi_k2": "moe family is not ported",
    "qwen2_moe": "moe family is not ported",
}


def _module(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_")
    if mod in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r}: {NOT_PORTED[mod]} (ROADMAP Queue 1 item 12)"
        )
    if mod not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    """The assigned ``ModelConfig`` of `arch`."""
    return _module(arch).CONFIG


def get_reduced(arch: str):
    """The small same-family ``ModelConfig`` of `arch` (CPU tests)."""
    return _module(arch).reduced()
