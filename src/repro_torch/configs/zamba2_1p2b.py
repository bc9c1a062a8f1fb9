"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention [arXiv:2411.15242; hf].

38 Mamba2 layers d_model=2048 ssm_state=64; one SHARED attention block
(32H MHA kv=32, d_ff=8192) applied every 6 layers; vocab 32000.
Sub-quadratic: runs the long_500k shape
(a copy of ``repro.configs.zamba2_1p2b``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_period=6,
    supports_long_context=True,
)


def reduced() -> ModelConfig:
    """Four ssm layers at d_model 64 (the shared block after layers 2 and 4:
    MHA 4/4 of 16, d_ff 128; 8 ssm heads of 16, state 16): the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        hybrid_period=2, remat="none",
    )
