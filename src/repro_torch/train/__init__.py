"""The single-replica train step (counterpart of ``repro.train``)."""
from repro_torch.train.step import (  # noqa: F401
    TrainConfig,
    ce_loss,
    make_train_state_defs,
    train_step,
)
