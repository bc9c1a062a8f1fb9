"""mamba2-1.3b [ssm]: SSD, attention-free [arXiv:2405.21060; unverified].

48L d_model=2048 ssm_state=128 vocab=50280, head_dim 64, expand 2.
Sub-quadratic: runs the long_500k shape (O(1)-state decode)
(a copy of ``repro.configs.mamba2_1p3b``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    supports_long_context=True,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64 (8 heads of 16, state 16): the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, remat="none",
    )
