"""Model configuration (the counterpart of ``repro.models.config``).

Every field of the JAX ``ModelConfig`` is kept, with the same name and
default, so a JAX configuration copies across field by field; dtypes are
torch dtypes. Every family of the JAX package runs in the port: dense,
moe, ssm, hybrid and encdec.

Kernel routing knobs (default ``auto``, or ``REPRO_KERNEL_MODE``):

  attention_kernel  full-sequence self-attention (``transformer.forward``):
                    ``jnp`` the inline einsum/softmax path of
                    ``models.layers``; otherwise a registry mode handed to
                    ``kernels.ops`` for ``flash_attention``: ``auto`` (the
                    CUDA kernel for CUDA tensors, its plain version on the
                    CPU), ``on`` (the kernel, or raise) or ``off`` (the
                    plain version). Decode and prefill pass a cache and take
                    the inline path whatever this says, as in the JAX package.
  decode_kernel     paged serving decode (``decode_step_paged``) through
                    ``decode_attention``; ``jnp`` means ``off``.
  ssm_kernel        the SSD within-chunk part of the ssm family's train,
                    scoring and prefill paths (``models.ssm._ssd_chunked``):
                    ``jnp`` the inline einsums, otherwise a registry mode
                    for ``ssd_chunk`` (forward and backward). The recurrent
                    decode step has no chunks and never takes it.

Pallas' ``interpret`` mode has no counterpart; a config naming it raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

KERNEL_KNOBS = ("attention_kernel", "decode_kernel", "ssm_kernel")
KNOB_VALUES = ("auto", "on", "off", "jnp")


def _kernel_default() -> str:
    """Default routing mode: ``auto`` unless ``REPRO_KERNEL_MODE`` says otherwise."""
    return os.environ.get("REPRO_KERNEL_MODE", "auto")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One model: the same fields as ``repro.models.config.ModelConfig``."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options ---------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    local_global: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None

    # --- MoE options --------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0

    # --- SSM (Mamba2/SSD) options ------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_head_block: int = 0

    # --- hybrid (zamba2) ------------------------------------------------------
    hybrid_period: int = 6

    # --- enc-dec (whisper) ----------------------------------------------------
    n_encoder_layers: int = 0
    encoder_len: int = 1500

    # --- numerics / misc -----------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # training-only (no effect on inference): the remat policy
    remat: str = "full"
    blockwise_attention: bool = False
    attention_block_k: int = 1024
    attention_kernel: str = dataclasses.field(default_factory=_kernel_default)
    ssm_kernel: str = dataclasses.field(default_factory=_kernel_default)
    decode_kernel: str = dataclasses.field(default_factory=_kernel_default)
    # sharding hints of the JAX package; identity on one card
    shard_q_heads: bool = False
    shard_residual_embed: bool = False

    # --- shape-grid participation -------------------------------------------
    supports_long_context: bool = False
    has_decoder: bool = True

    def __post_init__(self):
        for knob in KERNEL_KNOBS:
            value = getattr(self, knob)
            if value not in KNOB_VALUES:
                raise ValueError(
                    f"{knob}={value!r} not in {KNOB_VALUES} (Pallas' "
                    "'interpret' mode has no counterpart in the port)"
                )

    @property
    def q_dim(self) -> int:
        """Width of the concatenated query heads."""
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        """Width of the concatenated key (or value) heads."""
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba head count."""
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        """True for the pure-SSM family."""
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_mlp = 3 * d * ff
        moe_mlp = self.n_experts * 3 * d * self.moe_d_ff + (
            3 * d * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
        ) + d * self.n_experts
        di, st = self.ssm_d_inner, self.ssm_state
        nh = self.ssm_heads if self.ssm_d_inner else 0
        ssm_blk = (
            d * (2 * di + 2 * st + nh)
            + (di + 2 * st) * self.ssm_conv_width
            + nh * 2
            + di * d
        )
        per = {
            "dense": attn + dense_mlp,
            "moe": attn + moe_mlp,
            "ssm": ssm_blk,
            "hybrid": ssm_blk,
            "encdec": attn + dense_mlp,
        }[self.family]
        total = emb + self.n_layers * per
        if self.family == "hybrid":
            total += attn + dense_mlp
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn + dense_mlp)
            total += self.n_layers * attn
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: the routed top-k and the shared
        expert only; the JAX package's formula)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        act_mlp = self.experts_per_token * 3 * d * self.moe_d_ff + (
            3 * d * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
        ) + d * self.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + self.n_layers * (attn + act_mlp))
