"""Synthetic LiDAR scenes and KITTI-format trees (numpy only).

A copy of `_lidar_ground`, `sample_scene`, `scene_to_kitti_objects`,
`generate_kitti_dataset` and `_calib_file_text` from
`complex_yolov4_tpu/data/synthetic.py`: a ground plane with noise,
box-shaped object point clusters (Car / Pedestrian / Cyclist with
class-plausible dimensions) and clutter, deterministic from the seed, and
written in the exact KITTI directory layout:

    root/training/velodyne/000000.bin     (N, 4) float32 x y z intensity
    root/training/label_2/000000.txt      camera-frame label lines
    root/training/calib/000000.txt        P2 / R0_rect / Tr_velo_to_cam
    root/training/image_2/000000.png      (write_images only; needs cv2)
    root/ImageSets/{train,val,test}.txt

`tests/test_torch_port_copies.py` holds the copy equal to the original,
down to the bytes of a generated tree.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .kitti import Calibration, Object3d, default_calibration
from .transforms import lidar_to_camera_box

# (h, w, l) mean dims per class, roughly KITTI statistics.
_CLASS_DIMS = {
    0: (1.53, 1.63, 3.88),   # Car
    1: (1.76, 0.66, 0.84),   # Pedestrian
    2: (1.74, 0.60, 1.76),   # Cyclist
}
_CLASS_NAMES = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}
_GROUND_Z = -1.73  # velodyne sensor height above ground


def _lidar_ground(rng: np.random.Generator) -> np.ndarray:
    """Spinning-lidar ground returns: rays from discrete elevation beams at
    fixed azimuth steps intersected with the ground plane — many points per
    BEV cell near the sensor, sparse far out, as real KITTI scans."""
    elev = np.deg2rad(np.linspace(-24.8, -1.0, 56))          # downward beams
    az = np.deg2rad(np.arange(-60.0, 60.0, 0.42))            # front sector
    e, a = np.meshgrid(elev, az, indexing="ij")
    e = e + rng.normal(0.0, 2e-4, e.shape)                   # beam jitter
    a = a + rng.normal(0.0, 2e-4, a.shape)
    r = (-_GROUND_Z) / np.tan(-e)                            # ground range
    keep = (r > 2.0) & (r < 70.0)
    r, a = r[keep], a[keep]
    x = r * np.cos(a)
    y = r * np.sin(a)
    z = _GROUND_Z + rng.normal(0.0, 0.02, r.shape)
    i = rng.uniform(0.05, 0.3, r.shape)
    return np.stack([x, y, z, i], axis=-1)


def sample_scene(rng: np.random.Generator, max_objects: int = 10,
                 n_ground: int = 12000, n_clutter: int = 1500,
                 clustered: bool = False):
    """One synthetic scene -> (points (N,4) float32, lidar boxes (M,7), cls (M,)).

    Lidar boxes are (x, y, z_center, h, w, l, rz) in the velodyne frame.
    clustered=True swaps the uniform ground/clutter for a spinning-lidar
    beam model plus a few vertical surfaces (real-scan point-per-cell
    statistics); object clusters then thin out with range.
    """
    pts: List[np.ndarray] = []

    if clustered:
        pts.append(_lidar_ground(rng))
        # vertical surfaces (walls / vegetation): dense planar patches
        for _ in range(int(rng.integers(2, 6))):
            px = rng.uniform(8.0, 48.0)
            py = rng.uniform(-22.0, 22.0)
            width = rng.uniform(2.0, 10.0)
            height = rng.uniform(1.0, 3.0)
            yaw = rng.uniform(-np.pi, np.pi)
            n = int(np.clip(2000.0 * width * height / max(px, 4.0), 100, 1200))
            u = rng.uniform(-0.5, 0.5, n) * width
            v = rng.uniform(0.0, 1.0, n) * height
            wx = px + u * np.cos(yaw)
            wy = py + u * np.sin(yaw)
            wz = _GROUND_Z + v + rng.normal(0.0, 0.01, n)
            wi = rng.uniform(0.1, 0.6, n)
            pts.append(np.stack([wx, wy, wz, wi], axis=-1))
    else:
        gx = rng.uniform(0.0, 52.0, n_ground)
        gy = rng.uniform(-26.0, 26.0, n_ground)
        gz = _GROUND_Z + rng.normal(0.0, 0.03, n_ground)
        gi = rng.uniform(0.05, 0.3, n_ground)
        pts.append(np.stack([gx, gy, gz, gi], axis=-1))

        cx = rng.uniform(0.0, 52.0, n_clutter)
        cy = rng.uniform(-26.0, 26.0, n_clutter)
        cz = rng.uniform(_GROUND_Z, 1.2, n_clutter)
        ci = rng.uniform(0.0, 1.0, n_clutter)
        pts.append(np.stack([cx, cy, cz, ci], axis=-1))

    n_obj = int(rng.integers(1, max_objects + 1))
    boxes = []
    classes = []
    for _ in range(n_obj):
        cls = int(rng.integers(0, 3))
        h0, w0, l0 = _CLASS_DIMS[cls]
        h = h0 * rng.uniform(0.9, 1.1)
        w = w0 * rng.uniform(0.9, 1.1)
        l = l0 * rng.uniform(0.9, 1.1)
        x = rng.uniform(6.0, 44.0)
        y = rng.uniform(-20.0, 20.0)
        z = _GROUND_Z + h / 2
        yaw = rng.uniform(-np.pi, np.pi)

        # Surface points on the box (denser for bigger boxes, lidar-ish).
        # Clustered mode: density falls with range like a real scanner.
        if clustered:
            n_pts = int(np.clip(2500 * w * l * h / max(x, 4.0), 80, 1500))
        else:
            n_pts = int(np.clip(40 * w * l * h, 60, 500))
        face = rng.integers(0, 5, n_pts)  # 4 sides + top
        u = rng.uniform(-0.5, 0.5, n_pts)
        v = rng.uniform(-0.5, 0.5, n_pts)
        bx = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u))
        by = np.where(face == 2, 0.5, np.where(face == 3, -0.5, np.where(face < 2, u, v)))
        bz = np.where(face == 4, 0.5, np.where(face < 4, v, 0.5))
        local = np.stack([bx * l, by * w, bz * h], axis=-1)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        world = local @ rot.T + np.array([x, y, z])
        world += rng.normal(0.0, 0.01, world.shape)  # lidar measurement noise
        inten = rng.uniform(0.3, 0.9, (n_pts, 1))
        pts.append(np.concatenate([world, inten], axis=-1))

        boxes.append([x, y, z, h, w, l, yaw])
        classes.append(cls)

    points = np.concatenate(pts, axis=0).astype(np.float32)
    rng.shuffle(points, axis=0)
    return points, np.array(boxes, np.float64).reshape(-1, 7), np.array(classes, np.int32)


def scene_to_kitti_objects(boxes_lidar: np.ndarray, classes: np.ndarray,
                           calib: Calibration) -> List[Object3d]:
    """Lidar boxes -> camera-frame Object3d labels with projected 2-D boxes.

    KITTI labels locate boxes at the *bottom* face center in camera coords;
    lidar boxes here use the volumetric center, so z drops by h/2 first.
    """
    objects = []
    for box, cls in zip(boxes_lidar, classes):
        x, y, z, h, w, l, rz = box
        bottom = np.array([x, y, z - h / 2.0, h, w, l, rz])
        cam = lidar_to_camera_box(bottom[None], V2C=calib.V2C, R0=calib.R0)[0]
        cx, cy, cz, _, _, _, ry = cam

        obj = Object3d(
            type=_CLASS_NAMES[int(cls)],
            truncation=0.0,
            occlusion=0,
            alpha=float(-np.arctan2(cx, cz) + ry),
            box2d=np.array([0.0, 0.0, 50.0, 50.0], np.float32),
            h=float(h), w=float(w), l=float(l),
            t=(float(cx), float(cy), float(cz)),
            ry=float(ry),
        )
        from .kitti import compute_box_3d

        corners_2d, _ = compute_box_3d(obj, calib.P)
        if corners_2d is not None:
            x1, y1 = corners_2d.min(axis=0)
            x2, y2 = corners_2d.max(axis=0)
            obj.box2d = np.array([x1, y1, x2, y2], np.float32)
        objects.append(obj)
    return objects


def generate_kitti_dataset(root: str, num_train: int = 8, num_val: int = 4,
                           num_test: int = 2, seed: int = 0,
                           max_objects: int = 10,
                           write_images: bool = False) -> str:
    """Write a complete synthetic KITTI tree under `root`; returns `root`."""
    calib = default_calibration()
    calib_text = _calib_file_text(calib)

    splits = {"train": num_train, "val": num_val, "test": num_test}
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    next_id = 0
    for mode, count in splits.items():
        sub = "testing" if mode == "test" else "training"
        for d in ("velodyne", "label_2", "calib", "image_2"):
            os.makedirs(os.path.join(root, sub, d), exist_ok=True)
        ids = []
        for k in range(count):
            sid = next_id
            next_id += 1
            ids.append(sid)
            rng = np.random.default_rng(seed * 1_000_003 + sid)
            points, boxes, classes = sample_scene(rng, max_objects=max_objects)
            points.tofile(os.path.join(root, sub, "velodyne", f"{sid:06d}.bin"))
            objects = scene_to_kitti_objects(boxes, classes, calib)
            with open(os.path.join(root, sub, "label_2", f"{sid:06d}.txt"), "w") as f:
                f.write("\n".join(o.to_kitti_format() for o in objects) + "\n")
            with open(os.path.join(root, sub, "calib", f"{sid:06d}.txt"), "w") as f:
                f.write(calib_text)
            if write_images:
                import cv2

                img = np.full((375, 1242, 3), 90, np.uint8)
                cv2.imwrite(os.path.join(root, sub, "image_2", f"{sid:06d}.png"), img)
        with open(os.path.join(root, "ImageSets", f"{mode}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in ids) + "\n")
    return root


def _calib_file_text(calib: Calibration) -> str:
    def fmt(name, mat):
        return name + ": " + " ".join(f"{v:.12e}" for v in np.asarray(mat).ravel())

    p2 = calib.P
    return "\n".join([
        fmt("P0", p2), fmt("P1", p2), fmt("P2", p2), fmt("P3", p2),
        fmt("R0_rect", calib.R0),
        fmt("Tr_velo_to_cam", calib.V2C),
        fmt("Tr_imu_to_velo", calib.V2C),
    ]) + "\n"
