from .losses import get_loss, mae_loss, metrics, mre_loss, mse_loss
from .schedule import linear_warmup_decay, make_optimizer
from .trainer import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_batch,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "get_loss",
    "linear_warmup_decay",
    "mae_loss",
    "make_batch",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "metrics",
    "mre_loss",
    "mse_loss",
]
