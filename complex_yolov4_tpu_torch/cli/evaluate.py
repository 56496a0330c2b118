"""Evaluation CLI of the port (reference entry point parity: src/evaluate.py).

Counterpart of `complex_yolov4_tpu/cli/evaluate.py`: the same flags, plus
``--device`` (default ``cuda``; raises without CUDA unless ``--device
cpu``), and the same per-class lines and ``mAP:`` line. The default layout
is points: the loader ships padded points and the device rasters them;
``--cells_raster`` ships host-aggregated COO cells instead, and
``--host_raster`` host-rastered images. On a host with more than one CUDA
device the batch is split over the largest prefix of them that divides
``--batch_size`` (`parallel.make_mesh_for_batch`; the model replicated on
each, "eval data mesh: N device(s)"), and ``--cells_raster`` then ships
the batched (B, C) COO layout, which splits; one device serves as before.

Usage (synthetic smoke on the CPU):
    python -m complex_yolov4_tpu_torch.cli.evaluate --synthetic \\
        --model complex_yolov4_tiny --device cpu
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from ..config.kitti import CLASS_NAMES
from ..config.runtime import parse_eval_config
from ..data.loader import create_val_loader
from ..evaluation.evaluator import evaluate_map, make_inference_fn
from ..parallel import make_mesh_for_batch
from . import common


def main(argv=None, *, timings: Optional[Dict[str, List[float]]] = None):
    """Run the evaluation; returns (metric dict, the served `Darknet`).
    timings: passed to `evaluate_map` (per-batch host seconds)."""
    configs = parse_eval_config(argv)
    device = common.resolve_device(configs)
    dataset_dir = common.resolve_dataset_dir(configs)
    spec = common.resolve_spec(configs)
    params, state = common.init_or_load(spec, configs.pretrained_path)
    device_raster = not configs.host_raster
    cells_raster = configs.cells_raster and device_raster
    multi = device.type == "cuda" and torch.cuda.device_count() > 1
    loader = create_val_loader(dataset_dir, configs.batch_size,
                               num_samples=configs.num_samples,
                               device_raster=device_raster,
                               cells_raster=cells_raster,
                               cells_batched=cells_raster and multi)
    # int8 calibration needs host-rastered images; when the eval loader is
    # deferred (points or cells), calibrate on a host-raster twin instead
    calib_loader = (create_val_loader(dataset_dir, configs.batch_size,
                                      num_samples=configs.num_samples)
                    if device_raster and configs.quantize == "int8" else loader)
    model = common.maybe_quantize(spec, params, state, configs, calib_loader, device)
    devices = make_mesh_for_batch(configs.batch_size) if multi else []
    if len(devices) > 1:
        print(f"eval data mesh: {len(devices)} device(s)")
    infer = make_inference_fn(
        conf_thresh=configs.conf_thresh, nms_thresh=configs.nms_thresh,
        from_points=device_raster and not cells_raster,
        from_cells=cells_raster, devices=devices)  # val rasters at the native 608

    out = evaluate_map(
        infer, model, loader, iou_threshold=configs.iou_thresh,
        progress=lambda done, total: print(f"\reval {done}/{total}", end="",
                                           flush=True),
        timings=timings)
    print()
    for i, cls_idx in enumerate(out["ap_class"]):
        name = CLASS_NAMES[int(cls_idx)] if int(cls_idx) < len(CLASS_NAMES) else str(cls_idx)
        print(f"\t>>>\t Class {int(cls_idx)} ({name}): precision = {out['precision'][i]:.4f}, "
              f"recall = {out['recall'][i]:.4f}, AP = {out['AP'][i]:.4f}, "
              f"f1: {out['f1'][i]:.4f}")
    print(f"\nmAP: {float(out['mAP']):.4f}")
    return out, model


if __name__ == "__main__":
    main(sys.argv[1:])
