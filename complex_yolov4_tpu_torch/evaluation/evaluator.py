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
serves on the CPU only.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import kitti as cnf
from ..data import bev
from ..models.network import Darknet
from ..ops.nms import nms_batch
from . import metrics as M


def make_inference_fn(*, conf_thresh: float = 0.5, nms_thresh: float = 0.5,
                      max_boxes: int = 256, from_points: bool = False,
                      from_cells: bool = False,
                      img_size: Optional[int] = None) -> Callable:
    """-> infer(model, *inputs) returning (detections (B, max_boxes, 9),
    masks (B, max_boxes)) on the model's device.

    Detection rows are [x, y, w, l, im, re, conf, cls_conf, cls_id] in input
    pixels. Inputs (numpy or tensors; they are moved to the model's device):
    - default: infer(model, images), (B, S, S, 3) f32 rasters;
    - from_points: infer(model, points, point_mask, flip, holes, hole_mask),
      the loader's deferred batch; the device rasters it at the native 608
      (`bev.images_from_deferred_batch`) and resizes to `img_size`;
    - from_cells: infer(model, cells, keys, dens, batch_n, batch_cap=None),
      the flat (capacity,) arrays of `bev.pack_cells_flat`; `batch_cap` is
      the frame count they were packed for (default `batch_n`): pad frames
      raster empty and are sliced off; rasters at the native 608, then
      resizes to `img_size`.
    """
    if from_cells and from_points:
        raise ValueError("from_cells and from_points are exclusive")
    size = img_size or cnf.BEV_HEIGHT

    def net_tail(model: Darknet, images: torch.Tensor):
        decoded = model(images.permute(0, 3, 1, 2))  # NCHW view, channels_last
        return nms_batch(decoded, conf_thresh, nms_thresh, max_boxes)

    @torch.inference_mode()
    def infer_cells(model: Darknet, cells, keys, dens, batch_n: int,
                    batch_cap: Optional[int] = None):
        n = int(batch_n)
        dev = model.device
        cells = torch.as_tensor(cells, device=dev)
        if cells.dim() != 1:
            raise ValueError("flat (capacity,) COO layout expected")
        keys = torch.as_tensor(keys, device=dev)
        dens = torch.as_tensor(dens, device=dev)
        images = bev.make_bev_map_from_cells(cells, keys, dens, int(batch_cap or n))
        dets, masks = net_tail(model, bev.resize_images(images, size))
        return dets[:n], masks[:n]

    @torch.inference_mode()
    def infer_points(model: Darknet, points, point_mask, flip, holes, hole_mask):
        dev = model.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in (
            ("points", points), ("point_mask", point_mask), ("flip", flip),
            ("holes", holes), ("hole_mask", hole_mask))}
        return net_tail(model, bev.images_from_deferred_batch(batch, size))

    @torch.inference_mode()
    def infer_images(model: Darknet, images):
        return net_tail(model, torch.as_tensor(images, dtype=torch.float32,
                                               device=model.device))

    if from_cells:
        return infer_cells
    return infer_points if from_points else infer_images


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

    Batches are matched as they come: NMS syncs with the host every round,
    so an inference call returns with its batch done on the device, and
    the JAX package's one-batch-in-flight order would overlap nothing. The
    loader's prefetch thread overlaps the next batch's assembly.

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
