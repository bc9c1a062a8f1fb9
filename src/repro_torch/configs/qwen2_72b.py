"""qwen2-72b [dense]: GQA with QKV bias [arXiv:2407.10671; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
(a copy of ``repro.configs.qwen2_72b``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat="none",
    )
