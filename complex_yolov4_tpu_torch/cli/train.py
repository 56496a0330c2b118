"""Training CLI of the port (reference entry point parity: src/train.py).

Counterpart of `complex_yolov4_tpu/cli/train.py` on one process and one
device: the same flags (`config.runtime.TrainConfig`), plus ``--device``
(default ``cuda``; raises without CUDA unless ``--device cpu``). Step for
step as the original: initialize or load the weights, build the optimizer,
resume, then per epoch train on the device raster of the loader's deferred
batches (``--host_raster``, and ``--mosaic`` with its 4-frame canvases:
host-rastered images), read the losses once per print window, evaluate the
validation mAP in f32 on points through the serving `Darknet` (the 3x3
kernel's f32 instance on CUDA), and save an async checkpoint. Ctrl-C exits
130 after the in-flight save is joined. ``--remat`` checkpoints the
forward's activations (`TrainDarknet.forward`); ``--profile_steps N``
traces N steps from iteration ``--profile_start`` with `torch.profiler`
(host, and the card's kernels on CUDA) into ``logs_dir``, one
``*.pt.trace.json`` for TensorBoard or chrome://tracing.

The TPU-link knobs ``--epoch_preload``, ``--sync_checkpoint`` and
``--no_precompile_multiscale`` and the layout rewrite ``--batch_pack``
compute the same function: they are accepted and logged as not ported.
``--num_processes > 1`` raises a ValueError naming the ROADMAP item that
ports it.

Usage (synthetic smoke on the CPU):
    python -m complex_yolov4_tpu_torch.cli.train --synthetic --num_epochs 1 \\
        --model complex_yolov4_tiny --batch_size 2 --img_size 96 --device cpu
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import train as T
from ..config.runtime import parse_train_config
from ..data.loader import create_train_loader, create_val_loader
from ..evaluation.evaluator import evaluate_map, make_inference_fn
from ..models import weights
from ..models.network import TrainDarknet
from ..utils.logger import create_logger
from ..utils.meters import AverageMeter, ProgressMeter
from . import common

# flags that compute the same function on this stack: accepted, not ported
_INERT = ("epoch_preload", "sync_checkpoint", "no_precompile_multiscale", "batch_pack")


def _check_flags(configs, logger) -> None:
    if configs.num_processes > 1:
        raise ValueError("--num_processes > 1 is not ported yet: data-parallel training "
                         "is ROADMAP.md §1 item 2 (DDP)")
    for name in _INERT:
        if getattr(configs, name):
            logger.info("--%s: a TPU-side rewrite or link workaround, computing the same "
                        "function; not ported, ignored", name)


def _tensorboard(logs_dir: str, logger):
    """A tensorboardX writer, or None (one notice) where it is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.info("tensorboardX is not installed: no event file is written")
        return None
    return SummaryWriter(log_dir=logs_dir, filename_suffix="_torch")


def _start_profiler(logs_dir: str, device: torch.device):
    """A started `torch.profiler` trace of the host's ops (and the card's
    kernels on CUDA), written into `logs_dir` when it stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logs_dir))
    prof.start()
    return prof


def main(argv=None, *, timings: Optional[Dict[str, list]] = None):
    """Run the training; returns the final `TrainState`.

    timings: a dict that, when given, receives per micro-batch the host
    seconds of the step call ("step"), of the wait on the loader ("load")
    and of the whole iteration, that wait included ("iter"), and the loss
    ("loss", as the print windows read it); per epoch the validation mAP
    ("mAP") and the validation seconds ("val")."""
    configs = parse_train_config(argv)
    np.random.seed(configs.seed)
    torch.manual_seed(configs.seed)
    device = common.resolve_device(configs)
    configs.make_dirs()
    logger = create_logger(configs.logs_dir, configs.saved_fn)
    _check_flags(configs, logger)
    tb_writer = _tensorboard(configs.logs_dir, logger)

    dataset_dir = common.resolve_dataset_dir(configs)
    spec = common.resolve_spec(configs)
    params, bn_state = common.init_or_load(spec, configs.pretrained_path, configs.seed)
    model = TrainDarknet(spec, compute_dtype=common.compute_dtype_of(configs))
    model.load_state_dict(weights.to_train_state(spec, params, bn_state))
    model.to(device)
    logger.info("model %s: %d parameters, %d layers, %d boxes @ %d on %s",
                spec.name, sum(p.numel() for p in model.parameters()), len(spec.layers),
                spec.num_boxes(configs.img_size), configs.img_size, device)

    optimizer = T.create_optimizer(model, optimizer_type=configs.optimizer_type,
                                   momentum=configs.momentum,
                                   weight_decay=configs.weight_decay)
    state = T.TrainState(model=model, optimizer=optimizer)

    start_epoch = configs.start_epoch
    global_iter = 0
    if configs.resume_path:
        state, resumed_epoch = T.restore_checkpoint(configs.resume_path, state)
        start_epoch = resumed_epoch + 1
        # global_step counts micro-batches, as the loop's global_iter does
        global_iter = state.global_step
        logger.info("resumed from %s at epoch %d (iteration %d)",
                    configs.resume_path, resumed_epoch, global_iter)

    # mosaic samples are rastered on the host (the loader turns the device
    # raster off for them, as the JAX CLI does)
    device_raster = not configs.mosaic and not configs.host_raster
    subdivisions = max(configs.subdivisions, 1)
    step = T.make_train_step(use_giou_loss=configs.use_giou_loss, subdivisions=subdivisions,
                             remat=configs.remat)
    lr_fn = T.make_lr_fn(configs.lr_type, configs.lr, burn_in=configs.burn_in,
                         steps=configs.steps, num_epochs=configs.num_epochs)
    loader = create_train_loader(
        dataset_dir, configs.batch_size, num_samples=configs.num_samples,
        multiscale=configs.multiscale_training, mosaic=configs.mosaic,
        random_padding=configs.random_padding, seed=configs.seed,
        hflip_prob=configs.hflip_prob, cutout_prob=configs.cutout_prob,
        cutout_nholes=configs.cutout_nholes, cutout_ratio=configs.cutout_ratio,
        cutout_fill_value=configs.cutout_fill_value, device_raster=device_raster)
    logger.info("train loader: %d batches of %d (%s raster%s), subdivisions %d%s",
                len(loader), configs.batch_size, "device" if device_raster else "host",
                ", mosaic" if configs.mosaic else "", subdivisions,
                ", remat" if configs.remat else "")

    infer_fn = val_loader = None
    if not configs.no_val:
        # validation in f32 on points, as the JAX CLI's (train.py:145-148)
        val_loader = create_val_loader(dataset_dir, configs.batch_size,
                                       device_raster=not configs.host_raster)
        infer_fn = make_inference_fn(conf_thresh=configs.conf_thresh,
                                     nms_thresh=configs.nms_thresh,
                                     from_points=not configs.host_raster)

    if timings is not None:
        for key in ("step", "load", "iter", "loss", "mAP", "val"):
            timings.setdefault(key, [])
    prof = None  # the torch.profiler trace of --profile_steps, while it runs
    try:
        for epoch in range(start_epoch, configs.num_epochs + 1):
            loader.set_epoch(epoch)
            batch_time = AverageMeter("Time", ":6.3f")
            loss_meter = AverageMeter("Loss", ":.4e")
            progress = ProgressMeter(len(loader), [batch_time, loss_meter],
                                     prefix=f"Epoch [{epoch}/{configs.num_epochs}]")
            t0 = time.time()
            pending = []  # (batch size, device loss) not yet read
            t_load = time.perf_counter()
            for b_idx, batch in enumerate(loader):
                if timings is not None:
                    timings["load"].append(time.perf_counter() - t_load)
                # multi_step advances per optimizer iteration (train.py:213-218)
                lr = lr_fn(global_iter // subdivisions, epoch - 1)
                if configs.profile_steps and global_iter == configs.profile_start:
                    prof = _start_profiler(configs.logs_dir, device)
                img_size = int(batch.get("size", 0)) if device_raster else 0
                want_metrics = (global_iter + 1) % configs.tensorboard_freq == 0
                t_step = time.perf_counter()
                metrics = step(state, batch, lr, img_size, want_metrics)
                if timings is not None:
                    timings["step"].append(time.perf_counter() - t_step)
                global_iter += 1
                if prof is not None and global_iter >= (configs.profile_start
                                                        + configs.profile_steps):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    prof.stop()  # writes the trace
                    prof = None
                    logger.info("profiler trace of %d steps written to %s",
                                configs.profile_steps, configs.logs_dir)
                # the loss stays on the device until a print or tensorboard
                # window reads the window's losses in one transfer
                pending.append((batch["targets"].shape[0], metrics["loss"]))
                batch_time.update(time.time() - t0)
                t0 = time.time()
                want_print = b_idx % configs.print_freq == 0
                want_tb = tb_writer is not None and global_iter % configs.tensorboard_freq == 0
                if want_print or want_tb:
                    vals = torch.stack([v for _, v in pending]).cpu().tolist()
                    for (n_, _), v in zip(pending, vals):
                        loss_meter.update(v, n_)
                    pending.clear()
                    if timings is not None:
                        timings["loss"].extend(vals)
                if want_print:
                    logger.info(progress.get_message(b_idx))
                if want_tb:
                    tb_writer.add_scalar("train/lr", lr, global_iter)
                    tb_writer.add_scalar("train/loss", loss_meter.val, global_iter)
                    for k, v in metrics.items():
                        if k.startswith("head"):
                            tb_writer.add_scalar(f"train/{k}", float(v), global_iter)
                if timings is not None:
                    timings["iter"].append(time.perf_counter() - t_load)
                t_load = time.perf_counter()
            if pending:  # the epoch's tail of deferred loss reads
                vals = torch.stack([v for _, v in pending]).cpu().tolist()
                for (n_, _), v in zip(pending, vals):
                    loss_meter.update(v, n_)
                pending.clear()
                if timings is not None:
                    timings["loss"].extend(vals)
            logger.info("epoch %d train loss %.6g over %d samples", epoch, loss_meter.avg,
                        loss_meter.count)

            if val_loader is not None:
                t_val = time.perf_counter()
                serving = model.to_serving(device, torch.float32)
                out = evaluate_map(infer_fn, serving, val_loader,
                                   iou_threshold=configs.iou_thresh)
                del serving
                logger.info("epoch %d val mAP %.4f (AP per class: %s)", epoch,
                            float(out["mAP"]), np.round(out["AP"], 4).tolist())
                if timings is not None:
                    timings["mAP"].append(float(out["mAP"]))
                    timings["val"].append(time.perf_counter() - t_val)
                if tb_writer is not None:
                    tb_writer.add_scalar("val/mAP", float(out["mAP"]), epoch)

            if epoch % configs.checkpoint_freq == 0 or epoch == configs.num_epochs:
                T.save_checkpoint_async(configs.checkpoints_dir, state, epoch)
                logger.info("checkpoint save for epoch %d started (async, %s)",
                            epoch, T.checkpoint_path(configs.checkpoints_dir, epoch))
    finally:
        if prof is not None:  # the loop ended inside the traced steps
            prof.stop()
        # join (and surface the error of) an in-flight save, also when the
        # loop raises or is interrupted
        T.wait_for_async_save()
    if tb_writer is not None:
        tb_writer.close()
    logger.info("training done: %d epochs, %d iterations",
                configs.num_epochs - start_epoch + 1, global_iter)
    return state


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except KeyboardInterrupt:
        # graceful interrupt (reference: train.py:248-255)
        print("\ninterrupted — resume with --resume_path <checkpoints>/epoch_N.ckpt")
        sys.exit(130)
