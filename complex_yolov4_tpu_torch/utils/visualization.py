"""Visualization + KITTI-format prediction export (host-side).

A copy of `complex_yolov4_tpu/utils/visualization.py` (reference:
src/utils/visualization_utils.py:151-346; the optional mayavi 3-D viewer
is left out, as there), with one change: the functions that draw with
OpenCV import `cv2` when they run, not when the module is imported, since
the port runs where OpenCV is not installed (the card's host); a CLI asks
for it only when an output is drawn. `tests/test_torch_port_copies.py`
holds the copy equal to the original.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import kitti as cnf
from ..data.kitti import Calibration, Object3d, compute_box_3d
from ..data.targets import inverse_yolo_targets
from ..data.transforms import lidar_to_camera_box


def bev_to_uint8(bev: np.ndarray) -> np.ndarray:
    """(S, S, 3) float BEV map -> uint8 BGR image with the reference's
    channel order (R=density, G=height, B=intensity after RGB->BGR flip,
    reference: test.py:122-125)."""
    import cv2

    img = (bev * 255).clip(0, 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)


def draw_rotated_box(img: np.ndarray, x: float, y: float, w: float, l: float,
                     yaw: float, color) -> None:
    """Rotated rectangle + heading tick (reference: kitti_bev_utils.py:163-168)."""
    import cv2

    c, s = np.cos(yaw), np.sin(yaw)
    corners = np.array([
        [x - w / 2 * c - l / 2 * s, y - w / 2 * s + l / 2 * c],
        [x - w / 2 * c + l / 2 * s, y - w / 2 * s - l / 2 * c],
        [x + w / 2 * c + l / 2 * s, y + w / 2 * s - l / 2 * c],
        [x + w / 2 * c - l / 2 * s, y + w / 2 * s + l / 2 * c],
    ])
    pts = corners.reshape(-1, 1, 2).astype(np.int32)
    cv2.polylines(img, [pts], True, color, 2)
    p0, p3 = corners[0].astype(int), corners[3].astype(int)
    cv2.line(img, tuple(p0), tuple(p3), (255, 255, 0), 2)


def draw_detections_bev(img: np.ndarray, detections: np.ndarray,
                        det_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Draw NMS rows [x, y, w, l, im, re, conf, cls_conf, cls_id] (pixels)."""
    for i in range(detections.shape[0]):
        if det_mask is not None and det_mask[i] <= 0.5:
            continue
        x, y, w, l, im, re = detections[i, :6]
        cls_id = int(detections[i, 8])
        yaw = np.arctan2(im, re)
        draw_rotated_box(img, x, y, w, l, yaw,
                         cnf.COLORS[cls_id % len(cnf.COLORS)])
    return img


def draw_targets_bev(img: np.ndarray, targets: np.ndarray, mask: np.ndarray,
                     img_size: int) -> np.ndarray:
    """Draw normalized (T, 7) ground-truth targets
    (reference: kitti_bev_utils.py:171-180)."""
    for t, live in zip(targets, mask):
        if live <= 0.5:
            continue
        cls_id = int(t[0])
        yaw = np.arctan2(t[5], t[6])
        draw_rotated_box(img, t[1] * img_size, t[2] * img_size,
                         t[3] * img_size, t[4] * img_size, yaw,
                         cnf.COLORS[cls_id % len(cnf.COLORS)])
    return img


def detections_to_kitti_objects(
    detections: np.ndarray,
    det_mask: np.ndarray,
    calib: Calibration,
    img_shape_2d,
    img_size: float,
) -> List[Object3d]:
    """NMS rows -> camera-frame Object3d list with recovered alpha/2-D boxes
    (reference: visualization_utils.py:281-346)."""
    live = detections[det_mask > 0.5]
    if live.shape[0] == 0:
        return []
    rows = np.zeros((live.shape[0], 7), np.float64)
    rows[:, 0] = live[:, 8]
    rows[:, 1:5] = live[:, :4] / img_size
    rows[:, 5:7] = live[:, 4:6]
    labels = inverse_yolo_targets(rows)  # (N, 8) lidar [cls,x,y,z,h,w,l,ry]
    cam = lidar_to_camera_box(labels[:, 1:], V2C=calib.V2C, R0=calib.R0)

    names = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}
    objects: List[Object3d] = []
    corners3d = []
    for i in range(cam.shape[0]):
        x, y, z, h, w, l, ry = cam[i]
        obj = Object3d(
            type=names.get(int(labels[i, 0]), "Ignore"),
            truncation=-1.0, occlusion=-1, alpha=0.0,
            box2d=np.zeros(4, np.float32),
            h=float(h), w=float(w), l=float(l),
            t=(float(x), float(y), float(z)),
            ry=float(np.arctan2(np.sin(ry), np.cos(ry))),
            score=float(live[i, 6]),
        )
        _, c3d = compute_box_3d(obj, calib.P)
        corners3d.append(c3d)
        objects.append(obj)

    img_boxes, _ = calib.corners3d_to_img_boxes(np.array(corners3d))
    img_boxes[:, [0, 2]] = np.clip(img_boxes[:, [0, 2]], 0, img_shape_2d[1] - 1)
    img_boxes[:, [1, 3]] = np.clip(img_boxes[:, [1, 3]], 0, img_shape_2d[0] - 1)
    for i, obj in enumerate(objects):
        x, z = obj.t[0], obj.t[2]
        beta = np.arctan2(z, x)
        obj.alpha = -np.sign(beta) * np.pi / 2 + beta + obj.ry
        obj.box2d = img_boxes[i].astype(np.float32)
    return objects


def draw_objects_on_camera(img: np.ndarray, objects: Sequence[Object3d],
                           calib: Calibration) -> np.ndarray:
    """Project 3-D boxes into the camera image
    (reference: visualization_utils.py:151-165 + kitti_data_utils.py:415-435)."""
    import cv2

    for obj in objects:
        corners_2d, _ = compute_box_3d(obj, calib.P)
        if corners_2d is None:
            continue
        pts = corners_2d.astype(np.int32)
        color = cnf.COLORS[cnf.CLASS_NAME_TO_ID.get(obj.type, 0) % len(cnf.COLORS)]
        for k in range(4):
            cv2.line(img, tuple(pts[k]), tuple(pts[(k + 1) % 4]), color, 2)
            cv2.line(img, tuple(pts[k + 4]), tuple(pts[(k + 1) % 4 + 4]), color, 2)
            cv2.line(img, tuple(pts[k]), tuple(pts[k + 4]), color, 2)
    return img


def save_lidar_3d(points: np.ndarray, path: str,
                  boxes_lidar: Optional[np.ndarray] = None,
                  max_points: int = 30000) -> None:
    """3-D point-cloud view with optional lidar boxes, saved as an image
    (matplotlib stands in for the reference's optional mayavi viewer,
    reference: visualization_utils.py:14-134; VTK is not in this image)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = points
    if pts.shape[0] > max_points:
        pts = pts[np.random.default_rng(0).choice(pts.shape[0], max_points,
                                                  replace=False)]
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.2,
               c=pts[:, 2], cmap="viridis")
    if boxes_lidar is not None:
        for b in np.asarray(boxes_lidar).reshape(-1, 7):
            x, y, z, h, w, l, yaw = b
            c, s = np.cos(yaw), np.sin(yaw)
            dx = np.array([l, l, -l, -l]) / 2
            dy = np.array([w, -w, -w, w]) / 2
            cx = x + dx * c - dy * s
            cy = y + dx * s + dy * c
            for zz in (z - h / 2, z + h / 2):
                ax.plot(np.append(cx, cx[0]), np.append(cy, cy[0]),
                        zz * np.ones(5), "r-", linewidth=1)
            for k in range(4):
                ax.plot([cx[k], cx[k]], [cy[k], cy[k]],
                        [z - h / 2, z + h / 2], "r-", linewidth=1)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_box_aspect((2, 2, 0.5))
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def merge_rgb_to_bev(img_rgb: np.ndarray, img_bev: np.ndarray,
                     output_width: int) -> np.ndarray:
    """Stack camera view over BEV at a common width
    (reference: visualization_utils.py:200-217)."""
    import cv2

    rgb_h = int(output_width / img_rgb.shape[1] * img_rgb.shape[0])
    bev_h = int(output_width / img_bev.shape[1] * img_bev.shape[0])
    out = np.zeros((rgb_h + bev_h, output_width, 3), np.uint8)
    out[:rgb_h] = cv2.resize(img_rgb, (output_width, rgb_h))
    out[rgb_h:] = cv2.resize(img_bev, (output_width, bev_h))
    return out
