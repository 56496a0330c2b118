"""YOLO target encoding for BEV boxes (fixed-shape, mask-based).

A copy of `build_yolo_targets` and `MAX_TARGETS` from
`complex_yolov4_tpu/data/targets.py` (reference:
src/data_process/kitti_bev_utils.py:122-140): lidar-frame labels [cls, x,
y, z, h, w, l, ry] -> [cls, y_n, x_n, w_n, l_n, sin yaw, cos yaw], where
the BEV "x" column stores normalized lidar-y (axis swap), w/l are inflated
by +0.3 m, yaw := 2pi - ry, and boxes whose center is outside the boundary
are dropped; padded to a static `max_targets` with a validity mask.
`tests/test_torch_port_copies.py` holds the copy equal to the original.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import kitti as cnf

MAX_TARGETS = 64  # static per-frame target capacity (KITTI max ~25; mosaic 4x)


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
