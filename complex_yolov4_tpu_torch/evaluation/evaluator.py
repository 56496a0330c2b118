"""Serving and evaluation: input -> raster -> network -> decode -> rotated
NMS, then rotated-IoU matching and per-class AP.

Counterpart of `complex_yolov4_tpu/evaluation/evaluator.py`
(`make_inference_fn`, `evaluate_map`; reference: src/evaluate.py:23-64).
The weights are the model's buffers on its device; there is no per-call
weight upload and no cache keyed on object identity.

Three inputs, as in the JAX package: host-rastered images, a deferred
points batch that the device rasters (`from_points`), and flat COO cells
that the device rasters (`from_cells`). The model decides how the network
runs: a bf16 `Darknet` serves path 1 (stem and 3x3 kernels, cuDNN
elsewhere); a `Darknet(quant=..., fused_stages=True)` serves path 2, the
JAX package's `FUSED_STAGE=1 bench.py` configuration (int8 PTQ convs on
the int8 kernel, the CSP stages on the fused-stage kernel); an f32 model
serves in f32 (cuDNN in f32; the 3x3 kernel's f32 instance on CUDA only
with `conv3x3.F32_ENABLED`).

Several devices (`devices`, the JAX package's `mesh`): the model is
replicated once on each, the batch is split over them in order (a batch
that does not divide is zero-padded and the pad sliced off), the replicas'
forwards are all queued before any NMS reads its results back, and the
detections are concatenated in order.

Each call is one request of `utils/tracing.py` when a recording is open:
a `serve` span with `raster`, `network` (decode included) and `nms` spans
inside it, for every input and device count.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import kitti as cnf
from ..data import bev
from ..models.network import Darknet
from ..ops.nms import nms_batch
from ..utils import tracing
from . import metrics as M


def make_inference_fn(*, conf_thresh: float = 0.5, nms_thresh: float = 0.5,
                      max_boxes: int = 256, from_points: bool = False,
                      from_cells: bool = False,
                      img_size: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Callable:
    """-> infer(model, *inputs) returning (detections (B, max_boxes, 9),
    masks (B, max_boxes)) on the model's device (with `devices`, on the
    first of them).

    Detection rows are [x, y, w, l, im, re, conf, cls_conf, cls_id] in input
    pixels. Inputs (numpy or tensors; they are moved to the model's device):
    - default: infer(model, images), (B, S, S, 3) f32 rasters;
    - from_points: infer(model, points, point_mask, flip, holes, hole_mask),
      the loader's deferred batch; the device rasters it at the native 608
      (`bev.images_from_deferred_batch`) and resizes to `img_size`;
    - from_cells: infer(model, cells, keys, dens, batch_n, batch_cap=None),
      the flat (capacity,) arrays of `bev.pack_cells_flat`, or the (B, C)
      arrays of `bev.pack_cells_batched`; `batch_cap` is the frame count
      they were packed for (default `batch_n`): pad frames raster empty and
      are sliced off; rasters at the native 608, then resizes to `img_size`.

    devices: serve each batch split over these devices (`parallel.
    make_mesh_for_batch`), the model replicated once on each; the first
    replica is the model itself when it lies on the first device. A flat
    COO batch cannot split (its cell ids are batch-global) and raises with
    more than one device: use the batched layout.
    """
    if from_cells and from_points:
        raise ValueError("from_cells and from_points are exclusive")
    size = img_size or cnf.BEV_HEIGHT
    devs = [torch.device(d) for d in devices] if devices else []
    # model -> its replicas on `devs`, built at its first call
    replicas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def replicas_of(model: Darknet) -> List[Darknet]:
        if model not in replicas:
            replicas[model] = [model if i == 0 and model.device == d else model.replicate(d)
                               for i, d in enumerate(devs)]
        return replicas[model]

    def raster(dev, inputs, cap: Optional[int]) -> torch.Tensor:
        """(B, size, size, 3) f32 rasters of `inputs` on `dev`; cap: the
        frame count of a flat COO batch (None for every other input)."""
        with tracing.span("raster"):
            if from_cells:
                cells, keys, dens = (torch.as_tensor(x, device=dev) for x in inputs)
                if cap is None:
                    images = bev.make_bev_map_from_cells_batched(cells, keys, dens)
                else:
                    images = bev.make_bev_map_from_cells(cells, keys, dens, cap)
                return bev.resize_images(images, size)
            if from_points:
                batch = {k: torch.as_tensor(v, device=dev) for k, v in zip(
                    ("points", "point_mask", "flip", "holes", "hole_mask"), inputs)}
                return bev.images_from_deferred_batch(batch, size)
            return torch.as_tensor(inputs[0], dtype=torch.float32, device=dev)

    def forward(model: Darknet, images: torch.Tensor) -> torch.Tensor:
        with tracing.span("network"):
            return model(images.permute(0, 3, 1, 2))  # NCHW view, channels_last

    def nms(decoded: torch.Tensor):
        with tracing.span("nms"):
            return nms_batch(decoded, conf_thresh, nms_thresh, max_boxes)

    def run(model: Darknet, inputs, cap: Optional[int] = None):
        with tracing.span("serve"):
            reps = replicas_of(model) if devs else [model]
            with torch.inference_mode():
                if len(reps) == 1:
                    return nms(forward(reps[0], raster(reps[0].device, inputs, cap)))
                xs = [torch.as_tensor(x) for x in inputs]
                b = xs[0].shape[0]
                pad = (-b) % len(reps)
                if pad:  # zero frames: empty clouds, cells or images
                    xs = [torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in xs]
                per = (b + pad) // len(reps)
                # every replica's forward is queued before the first NMS; on the card
                # the NMS reads nothing back either, so no replica waits for another
                decoded = [forward(m, raster(m.device, [x[i * per:(i + 1) * per] for x in xs],
                                             None))
                           for i, m in enumerate(reps)]
                outs = [nms(d) for d in decoded]
                dets = torch.cat([d.to(devs[0]) for d, _ in outs])
                masks = torch.cat([m.to(devs[0]) for _, m in outs])
            return dets[:b], masks[:b]

    def infer_cells(model: Darknet, cells, keys, dens, batch_n: int,
                    batch_cap: Optional[int] = None):
        n = int(batch_n)
        cap = None
        if np.ndim(cells) == 1:
            if len(devs) > 1:
                raise ValueError("flat COO batches cannot split over devices: "
                                 "use the batched layout (cells_batched)")
            cap = int(batch_cap or n)
        elif np.ndim(cells) != 2:
            raise ValueError("flat (capacity,) or batched (B, C) COO layout expected")
        dets, masks = run(model, (cells, keys, dens), cap)
        return dets[:n], masks[:n]

    def infer(model: Darknet, *inputs):
        return run(model, inputs)

    return infer_cells if from_cells else infer


def evaluate_map(
    infer_fn: Callable,
    model: Darknet,
    loader,
    *,
    iou_threshold: float = 0.5,
    progress: Optional[Callable[[int, int], None]] = None,
    timings: Optional[Dict[str, List[float]]] = None,
) -> Dict[str, np.ndarray]:
    """Run the val split and compute precision/recall/AP/F1/mAP
    (reference protocol: evaluate.py:23-64 + evaluation_utils.py:70-190).

    Batches are matched as they come: matching reads the batch's
    detections back, which waits for the device. On the card the NMS reads
    nothing back, so an inference call returns with its batch still queued,
    and the JAX package's one-batch-in-flight order (the next batch
    launched before this one is matched) would overlap matching with the
    device; that order is not taken yet. The plain NMS (CPU, export) reads
    the host every round. The loader's prefetch thread overlaps the next
    batch's assembly.

    timings: a dict that, when given, receives per batch the host seconds
    spent waiting on the loader ("load"), in the inference call up to a
    synchronized device ("infer") and in matching ("match"), the live
    detections ("detections"), and the whole loop's seconds ("total")."""
    stats = []
    labels = []
    n_batches = len(loader)
    if timings is not None:
        for key in ("load", "infer", "match", "detections", "total"):
            timings.setdefault(key, [])
    t_start = t0 = time.perf_counter()
    for b_idx, batch in enumerate(loader):
        t1 = time.perf_counter()
        if "cells" in batch:  # COO batch: from_cells infer fn
            img_size = float(batch.get("size") or cnf.BEV_HEIGHT)
            dets, masks = infer_fn(model, batch["cells"], batch["cell_keys"],
                                   batch["cell_dens"], batch["batch"],
                                   batch.get("batch_cap", batch["batch"]))
        elif "image" in batch:
            img_size = float(batch["image"].shape[1])
            dets, masks = infer_fn(model, batch["image"])
        else:  # deferred batch: device-side raster (from_points infer fn)
            img_size = float(batch.get("size") or cnf.BEV_HEIGHT)
            dets, masks = infer_fn(model, batch["points"], batch["point_mask"],
                                   batch["flip"], batch["holes"], batch["hole_mask"])
        if timings is not None and dets.is_cuda:
            torch.cuda.synchronize(dets.device)
        t2 = time.perf_counter()
        targets, tmasks = batch["targets"], batch["target_mask"]
        batch_stats = M.batch_statistics(dets, masks, targets, tmasks, iou_threshold,
                                         img_size)
        stats.extend(batch_stats)
        for i in range(targets.shape[0]):
            labels.append(targets[i][tmasks[i] > 0.5][:, 0])
        if timings is not None:
            timings["load"].append(t1 - t0)
            timings["infer"].append(t2 - t1)
            timings["match"].append(time.perf_counter() - t2)
            timings["detections"].append(sum(len(s[0]) for s in batch_stats))
        if progress is not None:
            progress(b_idx + 1, n_batches)
        t0 = time.perf_counter()
    if timings is not None:
        timings["total"].append(time.perf_counter() - t_start)
    return M.summarize_map(stats, labels)
