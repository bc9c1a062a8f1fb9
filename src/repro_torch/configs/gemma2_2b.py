"""gemma2-2b [dense]: local+global alternating, logit softcaps [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, window=4096,
attn softcap 50, final softcap 30, head_dim 256, tied embeddings
(a copy of ``repro.configs.gemma2_2b``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    sliding_window=4096,
    local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    """Two layers (one local/global pair) at d_model 64: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=8, remat="none",
    )
