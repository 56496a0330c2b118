"""Training runtime: optimizer, schedules, the train step, checkpoints."""

from .checkpoint import (
    checkpoint_path,
    latest_epoch,
    restore_checkpoint,
    restore_params_and_bn,
    save_checkpoint_async,
    save_params_and_bn,
    wait_for_async_save,
)
from .optimizer import create_optimizer, set_learning_rate, weight_decay_groups
from .schedules import cosine_factor, make_lr_fn, multi_step_factor
from .trainer import TrainState, make_eval_step, make_train_step

__all__ = [
    "TrainState",
    "checkpoint_path",
    "cosine_factor",
    "create_optimizer",
    "latest_epoch",
    "make_eval_step",
    "make_lr_fn",
    "make_train_step",
    "multi_step_factor",
    "restore_checkpoint",
    "restore_params_and_bn",
    "save_checkpoint_async",
    "save_params_and_bn",
    "set_learning_rate",
    "wait_for_async_save",
    "weight_decay_groups",
]
