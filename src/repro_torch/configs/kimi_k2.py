"""kimi-k2-1t-a32b [moe]: trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048, 384 experts top-8
(+1 shared expert), vocab=163840 (a copy of ``repro.configs.kimi_k2``).

bf16 params: 1T float32 masters fit no single machine.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all-MoE FFNs
    vocab_size=163_840,
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    shared_expert_d_ff=2048,
    param_dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64, GQA 4/2, 8 experts top-2: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=256, n_experts=8, experts_per_token=2, moe_d_ff=32,
        shared_expert_d_ff=32, remat="none", param_dtype=torch.float32,
        capacity_factor=8.0,  # dropless at test scale: decode == forward
    )
