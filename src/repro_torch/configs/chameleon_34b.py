"""chameleon-34b [vlm]: early-fusion, VQ image tokens [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (one vocabulary of
text and image tokens). The VQ image tokenizer is a stub, as in the JAX
package: callers pass fused token ids over that vocabulary
(a copy of ``repro.configs.chameleon_34b``).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
)


def reduced() -> ModelConfig:
    """Two layers at d_model 64: the CPU tests' size."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat="none",
    )
