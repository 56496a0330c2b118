"""Frame conversions and the training augmentations (numpy, host side).

A copy of `complex_yolov4_tpu/data/transforms.py`: the box and frame
transforms (reference: src/data_process/transformation.py:30-104) and the
augmentations with explicit `np.random.Generator` state (`Compose`,
`OneOf`, `RandomRotation`, `RandomScaling` with `replicate_reference_bug`,
`HorizontalFlip`, `Cutout`, `default_lidar_transforms`,
`default_aug_transforms`; reference: transformation.py:315-437).
`tests/test_torch_port_copies.py` holds the copy equal to the original.

Conventions: camera-frame boxes are (x, y, z, h, w, l, ry); lidar-frame
boxes are (x, y, z, h, w, l, rz) with rz = -ry - pi/2 (the reference's
convention, transformation.py:83-104).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def rotate_z(pts: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (N, >=2) points about the lidar z axis."""
    c, s = np.cos(angle), np.sin(angle)
    out = pts.copy()
    out[:, 0] = pts[:, 0] * c - pts[:, 1] * s
    out[:, 1] = pts[:, 0] * s + pts[:, 1] * c
    return out


def lidar_box_rotate_z(boxes: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (N, 7) lidar boxes about z: centers rotate, yaw += angle.

    Matches the observable result of the reference's corner-space round trip
    (box_transform -> corner_to_center, transformation.py:287-304) without the
    lossy corner re-fit.
    """
    out = boxes.copy()
    out[:, :3] = np.hstack([rotate_z(boxes[:, :2], angle), boxes[:, 2:3]])
    out[:, 6] = boxes[:, 6] + angle
    return out


# ---------------------------------------------------------------------------
# Point-cloud-space augmentations (operate on lidar (N,4) + lidar boxes (M,7))
# ---------------------------------------------------------------------------

class Compose:
    """Apply all transforms in order with probability p
    (reference semantics: transformation.py:315-325)."""

    def __init__(self, transforms: Sequence, p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, rng: np.random.Generator, a, b):
        if rng.random() <= self.p:
            for t in self.transforms:
                a, b = t(rng, a, b)
        return a, b


class OneOf:
    """Apply one uniformly chosen transform with probability p
    (reference semantics: transformation.py:327-337)."""

    def __init__(self, transforms: Sequence, p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, rng: np.random.Generator, a, b):
        if rng.random() <= self.p:
            choice = int(rng.integers(0, len(self.transforms)))
            a, b = self.transforms[choice](rng, a, b)
        return a, b


class RandomRotation:
    """Global z-rotation of points + lidar boxes
    (reference: transformation.py:340-356)."""

    def __init__(self, limit_angle_deg: float = 20.0, p: float = 0.5):
        self.limit = limit_angle_deg / 180.0 * np.pi
        self.p = p

    def __call__(self, rng, lidar: np.ndarray, labels: np.ndarray):
        if rng.random() <= self.p:
            angle = rng.uniform(-self.limit, self.limit)
            rotated_xy = rotate_z(lidar[:, :2], angle)
            lidar = lidar.copy()
            lidar[:, :2] = rotated_xy  # z unchanged (no hstack round trip)
            labels = lidar_box_rotate_z(labels, angle)
        return lidar, labels


class RandomScaling:
    """Global scaling of points + boxes (reference: transformation.py:358-374).

    The reference samples `uniform(range[0], range[0])` — the factor is always
    the lower bound (a bug, SURVEY.md §7 quirks). `replicate_reference_bug`
    keeps that behavior for parity; set it False for the intended uniform draw.
    """

    def __init__(self, scaling_range: Tuple[float, float] = (0.95, 1.05), p: float = 0.5,
                 replicate_reference_bug: bool = True):
        self.range = scaling_range
        self.p = p
        self.replicate_reference_bug = replicate_reference_bug

    def __call__(self, rng, lidar: np.ndarray, labels: np.ndarray):
        if rng.random() <= self.p:
            hi = self.range[0] if self.replicate_reference_bug else self.range[1]
            factor = rng.uniform(self.range[0], hi)
            lidar = lidar.copy()
            labels = labels.copy()
            lidar[:, :3] *= factor
            labels[:, :6] *= factor
        return lidar, labels


# ---------------------------------------------------------------------------
# Image-space augmentations (operate on HWC BEV + padded targets)
#
# Targets are the fixed-shape (T, 7) [cls, x, y, w, l, im, re] rows with a
# (T,) validity mask — the TPU-friendly replacement for the reference's
# variable-length (n, 8) tensors (reference: transformation.py:376-437).
# ---------------------------------------------------------------------------

class HorizontalFlip:
    """Flip BEV width; x := 1-x, im := -im (reference: transformation.py:376-387)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, img: np.ndarray, targets_mask):
        targets, mask = targets_mask
        if rng.random() <= self.p:
            img = img[:, ::-1, :].copy()
            targets = targets.copy()
            targets[:, 1] = np.where(mask > 0, 1.0 - targets[:, 1], targets[:, 1])
            targets[:, 5] = np.where(mask > 0, -targets[:, 5], targets[:, 5])
        return img, (targets, mask)


class Cutout:
    """Square hole fill + drop targets whose center lies inside
    (reference: transformation.py:389-437)."""

    def __init__(self, n_holes: int = 1, ratio: float = 0.3, fill_value: float = 0.0,
                 p: float = 1.0):
        assert 0.0 <= fill_value <= 1.0
        self.n_holes = n_holes
        self.ratio = ratio
        self.fill_value = fill_value
        self.p = p

    def __call__(self, rng, img: np.ndarray, targets_mask):
        targets, mask = targets_mask
        if rng.random() <= self.p:
            img = img.copy()
            mask = mask.copy()
            h, w = img.shape[0], img.shape[1]
            ch, cw = int(self.ratio * h), int(self.ratio * w)
            for _ in range(self.n_holes):
                y = int(rng.integers(0, h))
                x = int(rng.integers(0, w))
                y1, y2 = np.clip(y - ch // 2, 0, h), np.clip(y + ch // 2, 0, h)
                x1, x2 = np.clip(x - cw // 2, 0, w), np.clip(x + cw // 2, 0, w)
                img[y1:y2, x1:x2, :] = self.fill_value
                tx = targets[:, 1] * w
                ty = targets[:, 2] * h
                inside = (x1 <= tx) & (tx <= x2) & (y1 <= ty) & (ty <= y2)
                mask = np.where(inside, 0.0, mask).astype(mask.dtype)
        return img, (targets, mask)


def default_lidar_transforms(replicate_reference_bug: bool = True) -> OneOf:
    """The reference training recipe's point-space augmentations
    (reference: src/data_process/kitti_dataloader.py:25-28)."""
    return OneOf(
        [
            RandomRotation(limit_angle_deg=20.0, p=1.0),
            RandomScaling(p=1.0, replicate_reference_bug=replicate_reference_bug),
        ],
        p=0.66,
    )


def default_aug_transforms(hflip_prob: float = 0.5, cutout_prob: float = 0.0,
                           cutout_nholes: int = 1, cutout_ratio: float = 0.3,
                           cutout_fill_value: float = 0.0) -> Compose:
    """The reference training recipe's image-space augmentations with its
    CLI-tunable probabilities (reference: src/data_process/kitti_dataloader.py:29-34,
    defaults from src/config/train_config.py:44-53)."""
    return Compose(
        [HorizontalFlip(p=hflip_prob),
         Cutout(n_holes=cutout_nholes, ratio=cutout_ratio,
                fill_value=cutout_fill_value, p=cutout_prob)],
        p=1.0,
    )
