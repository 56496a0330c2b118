"""Complex-YOLO head decode, in f32.

Counterpart of `complex_yolov4_tpu/models/yolo_head.py` `decode_head`
(reference: src/models/yolo_layer.py:144-190): sigmoid on x/y/conf/cls,
exp(w, l) clamped at 1e3 times the stride-scaled anchor, raw im/re,
plus grid-cell offsets; x/y/w/l come out in input-pixel units.
`scale_x_y` is stored in the spec but NOT applied, replicating the
reference quirk (yolo_layer.py:37 vs :161-162) the published checkpoints
were trained with. Boxes are flattened in (gy, gx, anchor) order, as the
JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .spec import YoloSpec

EXP_CLAMP_MAX = 1e3  # reference clamps exp(w/h) at 1E3 (yolo_layer.py:179-180)


def anchor_tensor(spec: YoloSpec, device) -> torch.Tensor:
    """The head's anchors (A, 4) as f32 on `device`."""
    return torch.tensor(spec.anchors, dtype=torch.float32, device=device)


def decode_head(feat: torch.Tensor, spec: YoloSpec, img_size: int,
                anchors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, A*(7+C), G, G) raw head conv output -> (B, G*G*A, 7+C) f32 rows
    [x, y, w, l, im, re, conf, cls...]: `decode_head_raw`'s fields, the box
    scaled from grid units to input pixels."""
    d = decode_head_raw(feat, spec, img_size, anchors)
    stride = img_size / d["grid_size"]
    boxes = d["pred_boxes"]
    rows = torch.cat([boxes[..., :4] * stride, boxes[..., 4:], d["pred_conf"][..., None],
                      d["pred_cls"]], dim=-1)
    return rows.reshape(feat.shape[0], -1, rows.shape[-1])


def decode_head_raw(feat: torch.Tensor, spec: YoloSpec, img_size: int,
                    anchors: Optional[torch.Tensor] = None) -> dict:
    """The grid-unit fields of the decode that the loss reads (the JAX
    `decode_head` dict without its `output`): (B, A*(7+C), G, G) raw head
    output -> pred_x, pred_y, pred_w, pred_h, pred_im, pred_re, pred_conf
    (B, G, G, A), pred_cls (B, G, G, A, C), pred_boxes (B, G, G, A, 6),
    scaled_anchors (A, 4) and grid_size, all f32 and differentiable.

    anchors: `spec.anchors` as an (A, 4) f32 tensor on feat's device, made
    once by the caller (`anchor_tensor`); None makes it here, which on a
    card is a host-to-device copy that waits for the stream, and so cannot
    run inside a CUDA graph's capture."""
    feat = feat.float()
    b, _, g, g2 = feat.shape
    if g != g2:
        raise ValueError("square grids only")
    na, nc = spec.num_anchors, spec.num_classes
    stride = img_size / g
    pred = feat.permute(0, 2, 3, 1).reshape(b, g, g, na, 7 + nc)
    dev = feat.device
    grid = torch.arange(g, dtype=torch.float32, device=dev)
    if anchors is None:
        anchors = anchor_tensor(spec, dev)
    anchor_w = anchors[:, 0] / stride
    anchor_h = anchors[:, 1] / stride
    pred_x = torch.sigmoid(pred[..., 0])
    pred_y = torch.sigmoid(pred[..., 1])
    pred_w, pred_h = pred[..., 2], pred[..., 3]
    pred_im, pred_re = pred[..., 4], pred[..., 5]
    bx = pred_x + grid.view(1, 1, g, 1)
    by = pred_y + grid.view(1, g, 1, 1)
    bw = torch.clamp(torch.exp(pred_w), max=EXP_CLAMP_MAX) * anchor_w
    bh = torch.clamp(torch.exp(pred_h), max=EXP_CLAMP_MAX) * anchor_h
    return {
        "grid_size": g,
        "scaled_anchors": torch.stack([anchor_w, anchor_h, anchors[:, 2], anchors[:, 3]], -1),
        "pred_x": pred_x, "pred_y": pred_y, "pred_w": pred_w, "pred_h": pred_h,
        "pred_im": pred_im, "pred_re": pred_re,
        "pred_conf": torch.sigmoid(pred[..., 6]),
        "pred_cls": torch.sigmoid(pred[..., 7:]),
        "pred_boxes": torch.stack([bx, by, bw, bh, pred_im, pred_re], dim=-1),
    }
