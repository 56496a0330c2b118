"""Serving entry: COO cells -> raster -> network -> decode -> rotated NMS.

Counterpart of `complex_yolov4_tpu/evaluation/evaluator.py`
`make_inference_fn(from_cells=True)` for the flat COO layout at the native
608 raster (no resize). The weights are the model's buffers on its device;
there is no per-call weight upload and no cache keyed on object identity.

The model decides how the network runs: a bf16 `Darknet` serves path 1
(stem and 3x3 kernels, cuDNN elsewhere); a `Darknet(quant=...,
fused_stages=True)` serves path 2, the JAX package's `FUSED_STAGE=1
bench.py` configuration (int8 PTQ convs on the int8 kernel, the CSP stages
on the fused-stage kernel), through this same function.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data import bev
from ..models.network import Darknet
from ..ops.nms import nms_batch


def make_inference_fn(*, conf_thresh: float = 0.5, nms_thresh: float = 0.5,
                      max_boxes: int = 256, from_cells: bool = True) -> Callable:
    """-> infer(model, cells, keys, dens, batch_n, batch_cap=None) returning
    (detections (batch_n, max_boxes, 9), masks (batch_n, max_boxes)).

    Detection rows are [x, y, w, l, im, re, conf, cls_conf, cls_id] in input
    pixels. `cells`, `keys`, `dens` are the flat (capacity,) arrays of
    `data.bev.pack_cells_flat` (numpy or tensors); they are moved to the
    model's device. `batch_cap` is the frame count the cells were packed
    for (default `batch_n`); pad frames are rastered empty and sliced off.
    """
    if not from_cells:
        raise ValueError("the port serves the COO cell layout only (from_cells=True)")

    @torch.inference_mode()
    def infer(model: Darknet, cells, keys, dens, batch_n: int,
              batch_cap: Optional[int] = None):
        n = int(batch_n)
        dev = model.device
        cells = torch.as_tensor(cells, device=dev)
        if cells.dim() != 1:
            raise ValueError("flat (capacity,) COO layout expected")
        keys = torch.as_tensor(keys, device=dev)
        dens = torch.as_tensor(dens, device=dev)
        images = bev.make_bev_map_from_cells(cells, keys, dens, int(batch_cap or n))
        decoded = model(images.permute(0, 3, 1, 2))  # NCHW view, channels_last
        dets, masks = nms_batch(decoded, conf_thresh, nms_thresh, max_boxes)
        return dets[:n], masks[:n]

    return infer
