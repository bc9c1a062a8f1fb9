"""whisper-small [audio]: enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

12+12L d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865. The audio conv
frontend is a stub, as in the JAX package: callers pass precomputed
(batch, 1500, d_model) frame embeddings (``enc_embeds``)
(a copy of ``repro.configs.whisper_small``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    encoder_len=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
)


def reduced() -> ModelConfig:
    """Two encoder and two decoder layers at d_model 64 over 32 frames: the
    CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, encoder_len=32, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        remat="none",
    )
