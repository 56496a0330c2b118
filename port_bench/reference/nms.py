"""Rotated NMS with confidence-weighted merging, plain numpy, in the
greedy form of the cfg's reference implementation (`post_processing_v2`,
src/utils/evaluation_utils.py of Complex-YOLOv4-Pytorch), and the
comparison of served detections with the reference's decoded boxes.

1. candidates: boxes with conf >= conf_thresh, ordered by conf * best-class
   probability (f32), the first k;
2. greedy: the best remaining candidate is kept; every remaining candidate
   of its class whose rotated IoU with it (the unmerged box) exceeds
   nms_thresh is removed into its group;
3. a kept row's box is the conf-weighted mean of its group's boxes (the
   kept box included); rows [x, y, w, l, im, re, conf, cls_conf, cls_id].
Rotated IoU by Sutherland-Hodgman clipping in float64; yaw = atan2(im,
re); corners as the reference's `get_corners` (kitti_bev_utils.py).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def corners(x, y, w, l, yaw) -> list:
    """The 4 corners [(x, y)], counter-clockwise: front-left, rear-left,
    rear-right, front-right."""
    c, s = math.cos(yaw), math.sin(yaw)
    out = []
    for sw, sl in ((-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0), (1.0, 1.0)):
        out.append((x + sw * w / 2 * c - sl * l / 2 * s, y + sw * w / 2 * s + sl * l / 2 * c))
    return out


def _clip(poly: list, a: tuple, b: tuple) -> list:
    """The part of convex `poly` left of the directed edge a -> b."""
    ex, ey = b[0] - a[0], b[1] - a[1]
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        sp = ex * (p[1] - a[1]) - ey * (p[0] - a[0])
        sq = ex * (q[1] - a[1]) - ey * (q[0] - a[0])
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def _area(poly: list) -> float:
    n = len(poly)
    if n < 3:
        return 0.0
    return 0.5 * abs(sum(poly[i][0] * poly[(i + 1) % n][1] - poly[(i + 1) % n][0] * poly[i][1]
                         for i in range(n)))


def rotated_iou(b1, b2) -> float:
    """IoU of two [x, y, w, l, yaw] boxes, in float64 Python arithmetic."""
    b1, b2 = [float(v) for v in b1], [float(v) for v in b2]
    poly, quad = corners(*b1), corners(*b2)
    for i in range(4):
        if not poly:
            break
        poly = _clip(poly, quad[i], quad[(i + 1) % 4])
    inter = _area(poly)
    union = b1[2] * b1[3] + b2[2] * b2[3] - inter
    return inter / max(union, 1e-6)


def _scores(decoded: np.ndarray, conf_thresh: float):
    conf = decoded[:, 6].astype(np.float32)
    cls_p = decoded[:, 7:].astype(np.float32)
    score = np.where(conf >= conf_thresh, conf * cls_p.max(axis=1), np.float32(-1e9))
    return score, cls_p.max(axis=1), cls_p.argmax(axis=1)


def greedy(decoded: np.ndarray, order: np.ndarray, conf_thresh: float,
           nms_thresh: float):
    """The kept rows, (n, 9) in candidate order, of the greedy NMS over the
    candidates `order` (indices into decoded, best first; all valid), the
    index into decoded of each row's kept box, (n,), and the indices of
    every box in a group of two or more, kept or merged."""
    _, cls_conf, cls_id = _scores(decoded, conf_thresh)
    k = len(order)
    cand = decoded[order].astype(np.float64)
    ccls = cls_id[order]
    boxes = np.stack([cand[:, 0], cand[:, 1], cand[:, 2], cand[:, 3],
                      np.arctan2(cand[:, 4], cand[:, 5])], axis=1).tolist()
    radius = (0.5 * np.hypot(cand[:, 2], cand[:, 3])).tolist()
    ccls = ccls.tolist()
    removed = [False] * k
    out, kept, grouped = [], [], []
    for i in range(k):
        if removed[i]:
            continue
        removed[i] = True
        group = [i]
        for j in range(i + 1, k):
            if removed[j] or ccls[j] != ccls[i]:
                continue
            if math.hypot(boxes[i][0] - boxes[j][0],
                          boxes[i][1] - boxes[j][1]) > radius[i] + radius[j]:
                continue
            if rotated_iou(boxes[i], boxes[j]) > nms_thresh:
                removed[j] = True
                group.append(j)
        wts = cand[group, 6]
        row = np.zeros(9)
        row[:6] = (wts[:, None] * cand[group, :6]).sum(0) / max(wts.sum(), 1e-16)
        row[6], row[7], row[8] = cand[i, 6], cls_conf[order[i]], ccls[i]
        out.append(row)
        kept.append(order[i])
        if len(group) > 1:
            grouped += [order[g] for g in group]
    return (np.array(out).reshape(-1, 9), np.array(kept, dtype=np.int64),
            np.array(grouped, dtype=np.int64))


def nms(decoded: np.ndarray, conf_thresh: float, nms_thresh: float, k: int) -> List[tuple]:
    """(B, N, 7+C) -> per frame `greedy`'s (kept rows, their kept boxes'
    indices, the indices of the boxes in merged groups), candidates in
    score order (ties in index order)."""
    out = []
    for d in decoded:
        score, _, _ = _scores(d, conf_thresh)
        valid = np.flatnonzero(score > -5e8)
        order = valid[np.argsort(-score[valid], kind="stable")][:k]
        out.append(greedy(d, order, conf_thresh, nms_thresh))
    return out


def box_strides(layers: List[dict], img_size: int, device) -> torch.Tensor:
    """(N,) the grid stride of each decoded box, in the decode's order."""
    parts = []
    for yolo in (layer for layer in layers if layer["type"] == "yolo"):
        g = img_size // yolo["stride"]
        parts.append(torch.full((g * g * len(yolo["anchors"]),), img_size / g,
                                dtype=torch.float64, device=device))
    return torch.cat(parts)


def _logit(p: torch.Tensor) -> torch.Tensor:
    return torch.logit(p.double(), eps=1e-7)


def row_gaps(served: torch.Tensor, decoded: torch.Tensor, stride: torch.Tensor,
             conf_thresh: float, k: int, kept_rows: np.ndarray, kept_index: np.ndarray,
             grouped: np.ndarray):
    """One frame's served kept rows (n, 9) against the reference's answer
    for that frame: its decoded boxes (N, 7+C) and its NMS (`nms`: kept
    rows, whose box is its group's merged box, their kept boxes, and the
    boxes of every group of two or more). In the units of the head's
    output: the centre in grid cells, log w and log l, im and re,
    logit(conf), and the logit of the served class conf against the
    reference's logit of the served class.

    - row gap: the largest of those seven differences to the nearest
      reference box or kept row (nearest by that largest difference); a
      row that names another class than its conf belongs to reads at
      least the gap between those two classes' logits;
    - clean: the nearest is a box that the reference merged with no other.
      A merged row is the mean of its group, and which needles join a group
      turns on rounding, so two right answers merge differently: only
      clean rows are compared box for box;
    - score gap: how far the reference's score logit (conf x best class,
      as the NMS ranks candidates) of the box or kept row nearest in
      geometry alone lies below the reference's k-th best score logit: a
      served row is one of the k best candidates of its frame.
    Returns (row gaps, clean, score gaps), each (n,); a gap is inf where a
    row has no finite gap or names no class."""
    dev = decoded.device
    at = torch.as_tensor(kept_index, dtype=torch.long, device=dev)
    merged = torch.as_tensor(kept_rows[:, :7], dtype=decoded.dtype, device=dev)
    cand = torch.cat([decoded, torch.cat([merged, decoded[at, 7:]], -1)])
    cand_stride = torch.cat([stride, stride[at]])
    in_group = torch.zeros(len(cand), dtype=torch.bool, device=dev)
    in_group[torch.as_tensor(grouped, dtype=torch.long, device=dev)] = True
    in_group[len(decoded):] = True
    s = served.double()[:, None, :]
    d = cand.double()[None]
    geometry = torch.stack([(s[..., 0] - d[..., 0]).abs() / cand_stride,
                            (s[..., 1] - d[..., 1]).abs() / cand_stride,
                            torch.log(s[..., 2] / d[..., 2]).abs(),
                            torch.log(s[..., 3] / d[..., 3]).abs(),
                            (s[..., 4] - d[..., 4]).abs(),
                            (s[..., 5] - d[..., 5]).abs()]).amax(0)
    conf = (_logit(s[..., 6]) - _logit(d[..., 6])).abs()
    n_cls = cand.shape[1] - 7
    cls = served[:, 8].double()
    named = (cls == cls.round()) & (cls >= 0) & (cls < n_cls)
    cls_logit = _logit(cand[:, 7:])[:, cls.clamp(0, n_cls - 1).long()].T  # (n, N + m)
    cls_gap = torch.where(named[:, None], (_logit(served[:, 7])[:, None] - cls_logit).abs(),
                          torch.full_like(cls_logit, float("inf")))
    dist = torch.nan_to_num(torch.maximum(torch.maximum(geometry, conf), cls_gap),
                            nan=float("inf"), posinf=float("inf"))
    gap, idx = dist.min(1)
    p = cand.double()
    score = torch.where(p[:, 6] >= conf_thresh, p[:, 6] * p[:, 7:].amax(-1),
                        torch.zeros_like(p[:, 6]))
    n_boxes = len(decoded)
    kth = _logit(score[:n_boxes].topk(min(k, n_boxes)).values[-1])
    near = torch.nan_to_num(geometry, nan=float("inf")).argmin(1)
    sgap = (kth - _logit(score[near])).clamp(min=0)
    return gap, ~in_group[idx], sgap
