"""The train step and the training state.

Counterpart of `complex_yolov4_tpu/train/trainer.py` (`TrainState`,
`make_train_step`, `make_eval_step`; reference: src/train.py:183-244). One
call of the step takes one micro-batch through the device raster (from the
loader's deferred batch, `data.bev.images_from_deferred_batch`) or the
host-rastered images, the train forward of `TrainDarknet`, `network_loss`
and the backward; the gradients add up over `subdivisions` micro-batches
and every k-th call steps the optimizer and zeroes them (the JAX package's
optax `MultiSteps` with its mean rescaled to the reference's sum). The
loss and metrics stay on the device; the caller reads them when it wants
them, as the JAX CLI does once per print window. f32 compute runs with TF32
off (`network.precision_scope`). `remat` checkpoints the activations of
the forward (`TrainDarknet.forward`), as the JAX step's `remat` does.

Data parallel (`TrainState.ddp`, from `parallel.wrap_ddp`): the forward
runs through DDP, BN and the loss's counts all-reduce over the model's
`process_group`, and the rank's loss, times the world size, is what the
backward differentiates, so that DDP's mean of the gradients is the
global batch's gradient (`losses.yolo_loss`). The micro-batches that only
accumulate run under `no_sync()`, so the gradients are all-reduced once per
optimizer step. The reported loss and metrics are all-reduced, those of
the global batch. Every rank runs the same number of micro-batches (equal
shards), so `global_step` stays equal on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..config import kitti as cnf
from ..data import bev as bev_mod
from ..losses.yolo_loss import network_loss
from ..models.network import TrainDarknet, precision_scope
from .optimizer import set_learning_rate


@dataclasses.dataclass
class TrainState:
    """Everything the step mutates: the module (parameters and running BN
    statistics), the optimizer and `global_step`, which counts
    micro-batches (as the JAX state's does); `ddp`, the module under DDP
    when the step is data parallel."""

    model: TrainDarknet
    optimizer: torch.optim.Optimizer
    global_step: int = 0
    ddp: Optional[DistributedDataParallel] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def batch_images(batch: Dict, device: torch.device, img_size: int = 0) -> torch.Tensor:
    """(B, 3, S, S) f32 rasters (NCHW view of NHWC memory) of a loader
    batch on `device`: the deferred batch rastered on the device at
    `img_size` (0: the native 608), or the host-rastered `image`."""
    if "image" in batch:
        img = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
    else:
        dev_batch = {k: torch.as_tensor(batch[k], device=device)
                     for k in ("points", "point_mask", "flip", "holes", "hole_mask")}
        img = bev_mod.images_from_deferred_batch(dev_batch, img_size or cnf.BEV_HEIGHT)
    return img.permute(0, 3, 1, 2)


def make_train_step(*, use_giou_loss: bool = False, subdivisions: int = 1,
                    remat: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(state, batch, lr, img_size=0, want_metrics=True) -> metrics.

    `batch`: a loader batch (deferred points or images, with `targets` and
    `target_mask`), numpy or tensors. Returns {"loss", "lr",
    "head{h}/{metric}"} as detached device tensors (lr a float); the state
    is updated in place: BN statistics every call, parameters and optimizer
    every `subdivisions`-th call (counted by `global_step`)."""
    k = max(int(subdivisions), 1)

    def step(state: TrainState, batch: Dict, lr: float, img_size: int = 0,
             want_metrics: bool = True) -> Dict[str, torch.Tensor]:
        model, dev = state.model, state.device
        group = model.process_group
        images = batch_images(batch, dev, img_size)
        targets = torch.as_tensor(batch["targets"], dtype=torch.float32, device=dev)
        tmask = torch.as_tensor(batch["target_mask"], dtype=torch.float32, device=dev)
        model.train()
        apply = (state.global_step + 1) % k == 0
        net, sync = model, contextlib.nullcontext()
        if state.ddp is not None:
            net = state.ddp
            if not apply:
                sync = state.ddp.no_sync()
        with precision_scope(model.compute_dtype, dev):
            with sync:
                heads = net(images, remat=remat)
                loss, head_metrics = network_loss(model.spec, heads, targets, tmask,
                                                  use_giou_loss=use_giou_loss,
                                                  want_metrics=want_metrics, group=group)
                (loss if group is None else loss * dist.get_world_size(group)).backward()
            state.global_step += 1
            if apply:
                set_learning_rate(state.optimizer, lr)
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
        names = [(h, name) for h, hm in enumerate(head_metrics) for name in hm]
        values = torch.stack([loss.detach()] + [head_metrics[h][name].detach()
                                                for h, name in names])
        if group is not None:
            dist.all_reduce(values, group=group)
        metrics = {"loss": values[0], "lr": lr}
        for (h, name), v in zip(names, values[1:]):
            metrics[f"head{h}/{name}"] = v
        return metrics

    return step


def make_eval_step(*, use_giou_loss: bool = False):
    """-> step(model, batch) -> (loss, per-head metrics): the validation
    loss of the eval forward (running BN statistics, the deployed model's;
    nothing updated). The model is left in eval mode; the train step sets
    train mode again."""
    @torch.no_grad()
    def step(model: TrainDarknet, batch: Dict):
        dev = next(model.parameters()).device
        images = batch_images(batch, dev)
        targets = torch.as_tensor(batch["targets"], dtype=torch.float32, device=dev)
        tmask = torch.as_tensor(batch["target_mask"], dtype=torch.float32, device=dev)
        with precision_scope(model.compute_dtype, dev):
            model.eval()
            heads = model(images)
            return network_loss(model.spec, heads, targets, tmask, use_giou_loss=use_giou_loss)

    return step
