"""Learning-rate schedules (reference: src/utils/train_utils.py:53-77).

A copy of the math of `complex_yolov4_tpu/train/schedules.py`
(`multi_step_factor`, `cosine_factor`, `make_lr_fn`): `multi_step` is a
quartic burn-in then x0.1 / x0.01 decays per optimizer iteration; `cosin`
is (1 + cos(pi * epoch / num_epochs)) / 2 * 0.9 + 0.1 per epoch. The
trainer multiplies the factor by the base LR and sets it on the optimizer
every step. `tests/test_torch_port_copies.py` holds the copy equal to the
original.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def multi_step_factor(burn_in: int, steps: Sequence[int]) -> Callable[[int], float]:
    s0, s1 = int(steps[0]), int(steps[1])

    def factor(iteration: int) -> float:
        if iteration < burn_in:
            return float(pow(iteration / burn_in, 4))
        if iteration < s0:
            return 1.0
        if iteration < s1:
            return 0.1
        return 0.01

    return factor


def cosine_factor(num_epochs: int) -> Callable[[int], float]:
    def factor(epoch: int) -> float:
        return ((1 + math.cos(epoch * math.pi / num_epochs)) / 2) * 0.9 + 0.1

    return factor


def make_lr_fn(lr_type: str, base_lr: float, *, burn_in: int = 50,
               steps: Sequence[int] = (1500, 4000), num_epochs: int = 300
               ) -> Callable[[int, int], float]:
    """(global_iteration, epoch_index) -> learning rate."""
    if lr_type == "multi_step":
        f = multi_step_factor(burn_in, steps)
        return lambda it, epoch: base_lr * f(it)
    if lr_type == "cosin":
        f = cosine_factor(num_epochs)
        return lambda it, epoch: base_lr * f(epoch)
    raise ValueError(f"unknown lr_type {lr_type!r} (multi_step|cosin)")
