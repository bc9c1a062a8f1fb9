"""Optimizers (counterpart of ``repro.optim``): AdamW and SGD-momentum, in place."""
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update  # noqa: F401
