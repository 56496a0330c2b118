"""YOLO target encoding and decoding for BEV boxes (fixed-shape, mask-based).

A copy of `build_yolo_targets`, `inverse_yolo_targets` and `MAX_TARGETS`
from `complex_yolov4_tpu/data/targets.py` (reference:
src/data_process/kitti_bev_utils.py:122-159): lidar-frame labels [cls, x,
y, z, h, w, l, ry] -> [cls, y_n, x_n, w_n, l_n, sin yaw, cos yaw], where
the BEV "x" column stores normalized lidar-y (axis swap), w/l are inflated
by +0.3 m, yaw := 2pi - ry, and boxes whose center is outside the boundary
are dropped; padded to a static `max_targets` with a validity mask; the
inverse decodes with fixed z = -1.55 and class-dependent heights (Car 1.5 /
Pedestrian 1.8 / Cyclist 1.4).
`tests/test_torch_port_copies.py` holds the copy equal to the original.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import kitti as cnf

MAX_TARGETS = 64  # static per-frame target capacity (KITTI max ~25; mosaic 4x)

_CLASS_HEIGHT = {0: 1.5, 1: 1.8, 2: 1.4}
_FIXED_Z = -1.55


def build_yolo_targets(
    labels: np.ndarray,
    boundary: Optional[Dict[str, float]] = None,
    max_targets: int = MAX_TARGETS,
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 8) lidar labels [cls,x,y,z,h,w,l,ry] -> ((T, 7) targets, (T,) mask).

    Target rows: [cls, bx, by, bw, bl, im, re], all geometry normalized to
    [0, 1] of the BEV extent; bx spans lidar-y, by spans lidar-x.
    """
    bc = boundary or cnf.BOUNDARY
    labels = np.asarray(labels, np.float64).reshape(-1, 8)
    x, y = labels[:, 1], labels[:, 2]
    keep = (
        (x > bc["minX"]) & (x < bc["maxX"]) & (y > bc["minY"]) & (y < bc["maxY"])
    )
    kept = labels[keep]
    n = min(kept.shape[0], max_targets)
    kept = kept[:n]

    targets = np.zeros((max_targets, 7), np.float32)
    mask = np.zeros((max_targets,), np.float32)
    if n:
        span_x = bc["maxX"] - bc["minX"]
        span_y = bc["maxY"] - bc["minY"]
        yaw = 2.0 * np.pi - kept[:, 7]
        targets[:n, 0] = kept[:, 0]
        targets[:n, 1] = (kept[:, 2] - bc["minY"]) / span_y          # bx <- lidar y
        targets[:n, 2] = (kept[:, 1] - bc["minX"]) / span_x          # by <- lidar x
        targets[:n, 3] = (kept[:, 5] + 0.3) / span_y                 # bw <- w + 0.3
        targets[:n, 4] = (kept[:, 6] + 0.3) / span_x                 # bl <- l + 0.3
        targets[:n, 5] = np.sin(yaw)
        targets[:n, 6] = np.cos(yaw)
        mask[:n] = 1.0
    return targets, mask


def inverse_yolo_targets(
    targets: np.ndarray,
    boundary: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """(T, 7) [cls, bx, by, bw, bl, im, re] -> (T, 8) lidar labels
    [cls, x, y, z, h, w, l, ry] (reference: kitti_bev_utils.py:141-159)."""
    bc = boundary or cnf.BOUNDARY
    targets = np.asarray(targets, np.float64).reshape(-1, 7)
    span_x = bc["maxX"] - bc["minX"]
    span_y = bc["maxY"] - bc["minY"]
    out = np.zeros((targets.shape[0], 8), np.float64)
    out[:, 0] = targets[:, 0]
    out[:, 1] = targets[:, 2] * span_x + bc["minX"]                   # lidar x
    out[:, 2] = targets[:, 1] * span_y + bc["minY"]                   # lidar y
    out[:, 3] = _FIXED_Z
    out[:, 4] = [_CLASS_HEIGHT.get(int(c), 1.5) for c in targets[:, 0]]
    out[:, 5] = targets[:, 3] * span_y - 0.3                          # w
    out[:, 6] = targets[:, 4] * span_x - 0.3                          # l
    out[:, 7] = -np.arctan2(targets[:, 5], targets[:, 6]) - 2.0 * np.pi
    return out
