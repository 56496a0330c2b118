"""Optimizer construction with the reference's parameter grouping.

Counterpart of `complex_yolov4_tpu/train/optimizer.py` (reference:
src/utils/train_utils.py:21-50): three parameter groups, as the reference
builds them: BN affine parameters (no weight decay), conv kernels (weight
decay) and biases (no weight decay); Adam, or SGD with Nesterov momentum.

The decay is coupled L2 added to the gradient before the inner optimizer,
as optax's `add_decayed_weights` before `adam`/`sgd`: torch's `Adam` and
`SGD` take their `weight_decay` the same way. optax's Adam (bias-corrected
moments, eps outside the square root) and Nesterov SGD (trace = g +
momentum * trace; update = g + momentum * trace) are the update rules of
torch's `Adam` and `SGD(nesterov=True, dampening=0)`.

Accumulation over `subdivisions` micro-batches is a SUM (the reference
calls backward() on every micro-batch without scaling, train.py:212-217;
the JAX package rescales optax `MultiSteps`' mean by k): gradients add up
in `.grad` and the trainer steps the optimizer on every k-th micro-batch.
The learning rate is set on every group before each step (`set_learning_rate`).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def weight_decay_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """{"bn": BN scale/bias, "w": conv kernels, "b": conv biases}: the
    reference's pg0, pg1 and pg2; only "w" (the JAX mask's 'w' leaves) is
    decayed."""
    groups: Dict[str, List[nn.Parameter]] = {"bn": [], "w": [], "b": []}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        groups["w" if leaf == "w" else "b" if leaf == "b" else "bn"].append(p)
    return groups


def create_optimizer(model: nn.Module, *, optimizer_type: str = "adam",
                     momentum: float = 0.949, weight_decay: float = 5e-4
                     ) -> torch.optim.Optimizer:
    """The optimizer over the three groups, LR 0 until `set_learning_rate`."""
    groups = weight_decay_groups(model)
    param_groups = [{"params": groups["bn"], "weight_decay": 0.0},
                    {"params": groups["w"], "weight_decay": weight_decay},
                    {"params": groups["b"], "weight_decay": 0.0}]
    if optimizer_type == "sgd":
        return torch.optim.SGD(param_groups, lr=0.0, momentum=momentum, nesterov=True)
    if optimizer_type == "adam":
        return torch.optim.Adam(param_groups, lr=0.0)
    raise ValueError(f"unknown optimizer_type {optimizer_type!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
