"""Frame conversions between the velodyne and rect-camera frames (numpy).

A copy of the box and frame transforms of
`complex_yolov4_tpu/data/transforms.py` (`_expand44`,
`camera_to_lidar_points`, `lidar_to_camera_points`, `camera_to_lidar_box`,
`lidar_to_camera_box`; reference: src/data_process/transformation.py:30-104).
The augmentations wait for the training slice.
`tests/test_torch_port_copies.py` holds the copy equal to the original.

Conventions: camera-frame boxes are (x, y, z, h, w, l, ry); lidar-frame
boxes are (x, y, z, h, w, l, rz) with rz = -ry - pi/2 (the reference's
convention, transformation.py:83-104).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import kitti as cnf


def _expand44(r0: Optional[np.ndarray], v2c: Optional[np.ndarray]):
    if r0 is None or v2c is None:
        return cnf.R0, cnf.Tr_velo_to_cam
    r = np.eye(4)
    r[:3, :3] = np.asarray(r0)[:3, :3]
    v = np.eye(4)
    v[:3, :4] = np.asarray(v2c)[:3, :4]
    return r, v


def camera_to_lidar_points(pts: np.ndarray, V2C=None, R0=None) -> np.ndarray:
    """(N, 3) rect-camera -> velodyne."""
    r, v = _expand44(R0, V2C)
    hom = np.hstack([pts, np.ones((pts.shape[0], 1))])
    out = (np.linalg.inv(v) @ np.linalg.inv(r) @ hom.T).T
    return out[:, :3]


def lidar_to_camera_points(pts: np.ndarray, V2C=None, R0=None) -> np.ndarray:
    """(N, 3) velodyne -> rect-camera."""
    r, v = _expand44(R0, V2C)
    hom = np.hstack([pts, np.ones((pts.shape[0], 1))])
    out = (r @ v @ hom.T).T
    return out[:, :3]


def camera_to_lidar_box(boxes: np.ndarray, V2C=None, R0=None, P2=None) -> np.ndarray:
    """(N, 7) camera (x,y,z,h,w,l,ry) -> lidar (x,y,z,h,w,l,rz), rz=-ry-pi/2
    (reference: src/data_process/transformation.py:83-94)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    xyz = camera_to_lidar_points(boxes[:, :3], V2C=V2C, R0=R0)
    out = boxes.copy()
    out[:, :3] = xyz
    out[:, 6] = -boxes[:, 6] - np.pi / 2
    return out


def lidar_to_camera_box(boxes: np.ndarray, V2C=None, R0=None, P2=None) -> np.ndarray:
    """(N, 7) lidar -> camera, inverse of camera_to_lidar_box."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    xyz = lidar_to_camera_points(boxes[:, :3], V2C=V2C, R0=R0)
    out = boxes.copy()
    out[:, :3] = xyz
    out[:, 6] = -boxes[:, 6] - np.pi / 2
    return out
