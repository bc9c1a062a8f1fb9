"""Checkpoints in the JAX package's on-disk layout (counterpart of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    CheckpointSpec,
    committed_steps,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
