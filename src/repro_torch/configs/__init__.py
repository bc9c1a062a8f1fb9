"""Configurations: the paper's experiments and the model registry.

``dsba_paper`` is a copy of ``repro.configs.dsba_paper``. The model
registry mirrors ``repro.configs``: ``--arch <id>`` (or an alias with
dashes and dots) selects a module exposing ``CONFIG`` (the assigned
configuration) and ``reduced()`` (a small same-family configuration for CPU
tests). Every id of the JAX registry is ported: the dense, moe, ssm,
hybrid and encdec families. An unknown id raises ``KeyError`` and never
falls back to another model.
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

PORTED = tuple(ARCH_IDS)


def _module(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_")
    if mod not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    """The assigned ``ModelConfig`` of `arch`."""
    return _module(arch).CONFIG


def get_reduced(arch: str):
    """The small same-family ``ModelConfig`` of `arch` (CPU tests)."""
    return _module(arch).reduced()


def list_archs() -> list[str]:
    """Every arch id of the registry, in the JAX registry's order."""
    return list(ARCH_IDS)
