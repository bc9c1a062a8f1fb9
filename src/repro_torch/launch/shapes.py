"""The assigned input-shape grid and per-(arch x shape) step inputs (the
counterpart of ``repro.launch.shapes``).

  train_4k     train_step   tokens/targets (256, 4096)
  prefill_32k  serve prefill — decode_step over the full (32, 32768) prompt
  decode_32k   serve decode — ONE new token, KV/SSM cache of 32768 (batch 128)
  long_500k    decode with 524288-token cache (batch 1) — sub-quadratic archs

long_500k runs only for archs with supports_long_context (mamba2, zamba2).

``input_specs`` builds the step's arguments as tensors on a device: on the
meta device (the dry run's default) they have shapes and dtypes and no
storage, the counterpart of the JAX ``ShapeDtypeStruct`` stand-ins. A
decode cell is the port's serving decode, ``decode_step_paged``: one new
token a row against a page pool that holds the cell's cache (pages of
``BLOCK_SIZE`` tokens, every row's ``seq - 1`` cached tokens on its own
pages), where ``decode_attention`` runs; the contiguous ``decode_step``
takes the plain attention in both packages.

The sharding half of the JAX module (``batch_axes_for``, ``cache_specs``
and the ``PartitionSpec`` of every input) waits for the sharded backend,
ROADMAP Queue 1 item 10: one card shards nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map

BLOCK_SIZE = 16  # tokens a page of a decode cell's pool (the serving pool's default)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cells_for(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k"]
    if cfg.has_decoder:
        names.append("decode_32k")
        if cfg.supports_long_context:
            names.append("long_500k")
    return names


def _tokens(batch: int, seq: int, device) -> torch.Tensor:
    return torch.zeros((batch, seq), dtype=torch.int32, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """The step's arguments on `device`, beside its parameters or state:

    train    {"tokens", "targets"} (batch, seq) int32, and for encdec
             "enc_embeds" (batch, encoder_len, d_model) in the compute dtype
    prefill  {"tokens": (batch, seq), "cache": ``T.init_cache(cfg, batch, seq)``}
    decode   {"tokens": (batch, 1), "pools": the zeroed pools of
             ``T.paged_cache_defs``, "table": (batch, n_pages) int32 (row b
             owns pages 1 + b n_pages ...), "lengths": (batch,) int32 of
             seq - 1 (the new token is the seq-th)}
    """
    B, S = shape.batch, shape.seq
    if shape.kind == "train":
        out = {"tokens": _tokens(B, S, device), "targets": _tokens(B, S, device)}
        if cfg.family == "encdec":
            out["enc_embeds"] = torch.zeros((B, cfg.encoder_len, cfg.d_model),
                                            dtype=cfg.compute_dtype, device=device)
        return out
    if shape.kind == "prefill":
        return {"tokens": _tokens(B, S, device), "cache": T.init_cache(cfg, B, S, device)}
    n_pages = -(-S // BLOCK_SIZE)
    pools = tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                     T.paged_cache_defs(cfg, B, B * n_pages + 1, BLOCK_SIZE, n_pages))
    table = torch.arange(1, B * n_pages + 1, dtype=torch.int32, device=device)
    return {"tokens": _tokens(B, 1, device), "pools": pools,
            "table": table.reshape(B, n_pages),
            "lengths": torch.full((B,), S - 1, dtype=torch.int32, device=device)}
