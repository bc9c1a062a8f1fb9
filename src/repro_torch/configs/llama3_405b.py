"""llama3-405b [dense]: GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
(a copy of ``repro.configs.llama3_405b``).

param_dtype is bf16: at 405B params, float32 masters and float32 Adam
moments fit no single machine.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    param_dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64 in float32: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat="none", param_dtype=torch.float32,
    )
