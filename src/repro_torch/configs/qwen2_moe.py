"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (MHA kv=16) expert d_ff=1408, 60 experts top-4,
shared expert d_ff 5632 (= 4 x 1408), vocab=151936
(a copy of ``repro.configs.qwen2_moe``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    n_experts=60,
    experts_per_token=4,
    moe_d_ff=1408,
    shared_expert_d_ff=5632,
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64, 8 experts top-2: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab_size=256, n_experts=8, experts_per_token=2, moe_d_ff=32,
        shared_expert_d_ff=64, remat="none",
        capacity_factor=8.0,  # dropless at test scale: decode == forward
    )
