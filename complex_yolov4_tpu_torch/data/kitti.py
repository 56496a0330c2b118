"""KITTI label / calibration / velodyne parsing (host-side, numpy).

Functional equivalent of the reference's Object3d/Calibration/read_label
(reference: src/data_process/kitti_data_utils.py:13,92,308), written
vectorized where the reference looped. Coordinate conventions follow the
KITTI devkit:

- velodyne frame: x forward, y left, z up;
- rect camera frame: x right, y down, z forward;
- label 3-D boxes live in the rect camera frame as (x, y, z, h, w, l, ry).

A copy of `complex_yolov4_tpu/data/kitti.py`; `tests/test_torch_port_copies.py` holds it
equal to the original.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import kitti as cnf


@dataclasses.dataclass
class Object3d:
    """One KITTI label line (camera-frame 3-D box + 2-D box + metadata)."""

    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # (4,) xmin, ymin, xmax, ymax
    h: float
    w: float
    l: float
    t: Tuple[float, float, float]  # camera-frame location
    ry: float
    score: float = -1.0

    @property
    def cls_id(self) -> int:
        return cnf.CLASS_NAME_TO_ID.get(self.type, -1)

    @property
    def dis_to_cam(self) -> float:
        return float(np.linalg.norm(self.t))

    @property
    def level_str(self) -> str:
        return ("UnKnown", "Easy", "Moderate", "Hard", "UnKnown")[self.level]

    @property
    def level(self) -> int:
        """KITTI difficulty from 2-D box height / truncation / occlusion
        (same thresholds as reference kitti_data_utils.py:58-72)."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 1
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 2
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 3
        return 4

    @classmethod
    def from_label_line(cls, line: str) -> "Object3d":
        parts = line.strip().split(" ")
        vals = [float(x) for x in parts[1:]]
        return cls(
            type=parts[0],
            truncation=vals[0],
            occlusion=int(vals[1]),
            alpha=vals[2],
            box2d=np.array(vals[3:7], dtype=np.float32),
            h=vals[7],
            w=vals[8],
            l=vals[9],
            t=(vals[10], vals[11], vals[12]),
            ry=vals[13],
            score=vals[14] if len(vals) >= 15 else -1.0,
        )

    def to_kitti_format(self) -> str:
        return (
            "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
            % (
                self.type, self.truncation, int(self.occlusion), self.alpha,
                self.box2d[0], self.box2d[1], self.box2d[2], self.box2d[3],
                self.h, self.w, self.l, self.t[0], self.t[1], self.t[2],
                self.ry, self.score,
            )
        )


def read_label(path: str) -> List[Object3d]:
    with open(path) as f:
        return [Object3d.from_label_line(ln) for ln in f if ln.strip()]


def read_velodyne(path: str) -> np.ndarray:
    """(N, 4) float32 [x, y, z, intensity] from a KITTI .bin."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _inverse_rigid(tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t] rigid transform."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class Calibration:
    """Per-frame KITTI calibration with vectorized frame conversions
    (API parity with reference kitti_data_utils.py:92-261)."""

    def __init__(self, calib_filepath: Optional[str] = None,
                 calib_dict: Optional[Dict[str, np.ndarray]] = None):
        calibs = calib_dict if calib_dict is not None else read_calib_file(calib_filepath)
        self.P = np.reshape(np.asarray(calibs["P2"], np.float64), (3, 4))
        self.P2 = self.P
        self.P3 = np.reshape(np.asarray(calibs["P3"], np.float64), (3, 4)) if "P3" in calibs else None
        self.V2C = np.reshape(np.asarray(calibs["Tr_velo_to_cam"], np.float64), (3, 4))
        self.C2V = _inverse_rigid(self.V2C)
        self.R0 = np.reshape(np.asarray(calibs["R0_rect"], np.float64), (3, 3))

        # Camera intrinsics recovered from P2.
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    # ---- homogeneous helpers ----

    @staticmethod
    def cart_to_hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)))

    # ---- velodyne <-> camera ----

    def project_velo_to_ref(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.cart_to_hom(pts_velo) @ self.V2C.T

    def project_ref_to_velo(self, pts_ref: np.ndarray) -> np.ndarray:
        return self.cart_to_hom(pts_ref) @ self.C2V.T

    def project_rect_to_ref(self, pts_rect: np.ndarray) -> np.ndarray:
        return (np.linalg.inv(self.R0) @ pts_rect.T).T

    def project_ref_to_rect(self, pts_ref: np.ndarray) -> np.ndarray:
        return (self.R0 @ pts_ref.T).T

    def project_velo_to_rect(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts_velo))

    def project_rect_to_velo(self, pts_rect: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts_rect))

    # ---- camera <-> image ----

    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        pts_2d = self.cart_to_hom(pts_rect) @ self.P.T
        return pts_2d[:, :2] / pts_2d[:, 2:3]

    def project_velo_to_image(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))

    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """(N, 3) [u, v, depth] -> (N, 3) rect-camera points."""
        n = uv_depth.shape[0]
        x = ((uv_depth[:, 0] - self.c_u) * uv_depth[:, 2]) / self.f_u + self.b_x
        y = ((uv_depth[:, 1] - self.c_v) * uv_depth[:, 2]) / self.f_v + self.b_y
        out = np.zeros((n, 3))
        out[:, 0], out[:, 1], out[:, 2] = x, y, uv_depth[:, 2]
        return out

    def project_image_to_velo(self, uv_depth: np.ndarray) -> np.ndarray:
        return self.project_rect_to_velo(self.project_image_to_rect(uv_depth))

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) rect-frame corners -> ((N, 4) image boxes, (N, 8, 2) corners)."""
        n = corners3d.shape[0]
        hom = np.concatenate((corners3d, np.ones((n, 8, 1))), axis=2)  # (N, 8, 4)
        img_pts = hom @ self.P.T  # (N, 8, 3)
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        x1, y1 = np.min(x, axis=1), np.min(y, axis=1)
        x2, y2 = np.max(x, axis=1), np.max(y, axis=1)
        boxes = np.concatenate(
            (x1.reshape(-1, 1), y1.reshape(-1, 1), x2.reshape(-1, 1), y2.reshape(-1, 1)),
            axis=1)
        corners_in_image = np.concatenate((x[..., None], y[..., None]), axis=2)
        return boxes, corners_in_image


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    data: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def default_calibration() -> Calibration:
    """Calibration built from the dataset-average matrices
    (reference: src/config/kitti_config.py:42-65), for frames without files."""
    return Calibration(calib_dict={
        "P2": cnf.P2[:3, :],
        "P3": cnf.P2[:3, :],
        "R0_rect": cnf.R0[:3, :3],
        "Tr_velo_to_cam": cnf.Tr_velo_to_cam[:3, :],
    })


def objects_to_bev_labels(objects: Sequence[Object3d]) -> Tuple[np.ndarray, bool]:
    """Known-class objects -> (N, 8) [cls, x, y, z, h, w, l, ry] camera-frame
    rows; returns (labels, no_objects) with a single zero row when empty
    (reference semantics: src/data_process/kitti_bev_utils.py:79-95)."""
    rows = [
        [obj.cls_id, obj.t[0], obj.t[1], obj.t[2], obj.h, obj.w, obj.l, obj.ry]
        for obj in objects
        if obj.cls_id != -1
    ]
    if not rows:
        return np.zeros((1, 8), dtype=np.float32), True
    return np.array(rows, dtype=np.float32), False


def compute_box_3d(obj: Object3d, calib_p: np.ndarray):
    """Camera-frame 3-D box -> image-projected 8 corners + rect-frame corners
    (reference: src/data_process/kitti_data_utils.py:347-383). Returns
    (corners_2d | None, corners_3d)."""
    ry = obj.ry
    rot = np.array([
        [np.cos(ry), 0, np.sin(ry)],
        [0, 1, 0],
        [-np.sin(ry), 0, np.cos(ry)],
    ])
    l, w, h = obj.l, obj.w, obj.h
    x_c = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y_c = [0, 0, 0, 0, -h, -h, -h, -h]
    z_c = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners_3d = rot @ np.vstack([x_c, y_c, z_c])
    corners_3d = corners_3d + np.asarray(obj.t).reshape(3, 1)
    if np.any(corners_3d[2, :] < 0.1):
        return None, corners_3d.T
    hom = np.vstack([corners_3d, np.ones((1, 8))])
    pts = calib_p @ hom
    corners_2d = (pts[:2] / pts[2]).T
    return corners_2d, corners_3d.T


_SPLIT_SUBDIR = {"train": "training", "val": "training", "test": "testing"}


def split_paths(dataset_dir: str, mode: str) -> Dict[str, str]:
    sub = _SPLIT_SUBDIR[mode]
    return {
        "lidar": os.path.join(dataset_dir, sub, "velodyne"),
        "image": os.path.join(dataset_dir, sub, "image_2"),
        "calib": os.path.join(dataset_dir, sub, "calib"),
        "label": os.path.join(dataset_dir, sub, "label_2"),
        "split_file": os.path.join(dataset_dir, "ImageSets", f"{mode}.txt"),
    }
