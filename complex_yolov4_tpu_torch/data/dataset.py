"""KITTI BEV dataset: file loading -> augmentation -> raster -> targets.

A copy of `KittiDataset` of `complex_yolov4_tpu/data/dataset.py` (reference:
src/data_process/kitti_dataset.py:29-121) in its train, val and test
modes, with `load_sample` and `load_bev_only`: the same split filtering,
labels, targets and augmentations with an explicit `np.random.Generator`.
The host raster is the numpy `bev.make_bev_map`, which the JAX package's
native C++ rasterizer equals bit for bit; the native copy and mosaic wait
for a later slice (ROADMAP §1, the native host rasterizer with mosaic).
With `defer_raster=True` no image is built: an `_AugProbe` (a copy of the
original's) records the flip and cutout decisions from the same random
draws, and the augmented cloud comes back beside it, for the device
rasters. `tests/test_torch_port_copies.py` holds the samples equal to the
original's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import kitti as cnf
from . import bev as bev_mod
from . import targets as tgt_mod
from .kitti import (
    Calibration,
    Object3d,
    objects_to_bev_labels,
    read_label,
    read_velodyne,
    split_paths,
)
from .transforms import camera_to_lidar_box


class _ProbeUnsupported(TypeError):
    """An image-space transform did something the aug probe can't record."""


class _AugProbe:
    """Records image-space augmentation decisions without an image.

    Stands in for the (H, W, 3) BEV array when rasterization is deferred to
    the fused native mosaic: the REAL transform objects run with their normal
    RNG draws (so the random stream is bit-identical to the numpy path), but
    instead of moving pixels they record `flipped` and cutout `holes`
    (y1, y2, x1, x2, fill), which the C++ pass applies as index math.
    Supports exactly the ndarray ops HorizontalFlip/Cutout perform; anything
    else raises `_ProbeUnsupported`, which falls back to the numpy path.
    """

    __slots__ = ("shape", "flipped", "holes")

    def __init__(self, h: int, w: int):
        self.shape = (h, w, 3)
        self.flipped = False
        self.holes: List[Tuple[int, int, int, int, float]] = []

    def copy(self) -> "_AugProbe":
        return self

    def __getitem__(self, key):
        # HorizontalFlip's img[:, ::-1, :]
        full = slice(None, None, None)
        if (isinstance(key, tuple) and len(key) == 3 and key[0] == full
                and key[1] == slice(None, None, -1) and key[2] == full):
            out = _AugProbe(self.shape[0], self.shape[1])
            out.flipped = not self.flipped
            out.holes = list(self.holes)
            return out
        raise _ProbeUnsupported(f"unsupported probe slice {key!r}")

    def __setitem__(self, key, value):
        # Cutout's img[y1:y2, x1:x2, :] = fill
        if (isinstance(key, tuple) and len(key) == 3
                and isinstance(key[0], slice) and isinstance(key[1], slice)
                and key[2] == slice(None, None, None)
                and key[0].step is None and key[1].step is None
                and np.isscalar(value)):
            self.holes.append((int(key[0].start), int(key[0].stop),
                               int(key[1].start), int(key[1].stop),
                               float(value)))
            return
        raise _ProbeUnsupported(f"unsupported probe assignment {key!r}")


class KittiDataset:
    """Indexable KITTI BEV dataset (train / val / test modes)."""

    def __init__(
        self,
        dataset_dir: str,
        mode: str = "val",
        lidar_transforms=None,
        aug_transforms=None,
        num_samples: Optional[int] = None,
        mosaic: bool = False,
        max_targets: int = tgt_mod.MAX_TARGETS,
        img_size: int = cnf.BEV_WIDTH,
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"invalid mode {mode!r}")
        if mosaic:
            raise ValueError("mosaic is not ported yet: it comes with the native host "
                             "rasterizer and cyv4_mosaic (ROADMAP.md §1 item 1)")
        self.dataset_dir = dataset_dir
        self.mode = mode
        self.is_test = mode == "test"
        self.paths = split_paths(dataset_dir, mode)
        self.lidar_transforms = lidar_transforms
        self.aug_transforms = aug_transforms
        self.mosaic = mosaic
        self.max_targets = max_targets
        self.img_size = img_size

        with open(self.paths["split_file"]) as f:
            idx_list = [ln.strip() for ln in f if ln.strip()]
        if self.is_test:
            self.sample_id_list = [int(s) for s in idx_list]
        else:
            self.sample_id_list = self._remove_invalid_idx(idx_list)
        if num_samples is not None:
            self.sample_id_list = self.sample_id_list[:num_samples]

    def __len__(self) -> int:
        return len(self.sample_id_list)

    # ---- raw file access ----

    def get_lidar(self, sample_id: int) -> np.ndarray:
        return read_velodyne(os.path.join(self.paths["lidar"], f"{sample_id:06d}.bin"))

    def get_label(self, sample_id: int) -> List[Object3d]:
        return read_label(os.path.join(self.paths["label"], f"{sample_id:06d}.txt"))

    def get_calib(self, sample_id: int) -> Calibration:
        return Calibration(os.path.join(self.paths["calib"], f"{sample_id:06d}.txt"))

    def get_image_path(self, sample_id: int) -> str:
        return os.path.join(self.paths["image"], f"{sample_id:06d}.png")

    # ---- sample assembly ----

    def load_bev_only(self, index: int) -> Tuple[str, np.ndarray]:
        """Test mode: BEV raster only (reference: kitti_dataset.py:76-85)."""
        sample_id = self.sample_id_list[index]
        cropped = bev_mod.remove_points_outside(self.get_lidar(sample_id))
        return self.get_image_path(sample_id), bev_mod.make_bev_map(cropped)

    def load_sample(self, index: int, rng: Optional[np.random.Generator] = None,
                    defer_raster: bool = False):
        """(img_path, bev HWC, targets (T,7), mask (T,)) for one frame
        (reference: kitti_dataset.py:87-121): the lidar transforms on the
        cloud and its boxes, the raster, the targets, then the image-space
        transforms on the raster and targets. With `defer_raster=True` no
        image is built: `img` comes back as ``(_AugProbe, points)``, the
        flip and cutout decisions and the augmented cloud, from the same
        random draws."""
        rng = rng or np.random.default_rng()
        sample_id = self.sample_id_list[index]
        lidar = self.get_lidar(sample_id)
        calib = self.get_calib(sample_id)
        labels, no_obj = objects_to_bev_labels(self.get_label(sample_id))
        if not no_obj:
            labels[:, 1:] = camera_to_lidar_box(labels[:, 1:], V2C=calib.V2C, R0=calib.R0)

        if self.lidar_transforms is not None:
            lidar, labels[:, 1:] = self.lidar_transforms(rng, lidar, labels[:, 1:])

        if defer_raster:
            img = _AugProbe(cnf.BEV_HEIGHT, cnf.BEV_WIDTH)
        else:
            img = bev_mod.make_bev_map(bev_mod.remove_points_outside(lidar))
        targets, mask = tgt_mod.build_yolo_targets(
            labels if not no_obj else np.zeros((0, 8), np.float32),
            max_targets=self.max_targets,
        )

        if self.aug_transforms is not None:
            img, (targets, mask) = self.aug_transforms(rng, img, (targets, mask))
        if defer_raster:
            return self.get_image_path(sample_id), (img, lidar), targets, mask
        return self.get_image_path(sample_id), img, targets, mask

    def get_item(self, index: int, rng: Optional[np.random.Generator] = None):
        """(path, img, targets, mask); test mode has no targets (None)."""
        if self.is_test:
            path, img = self.load_bev_only(index)
            return path, img, None, None
        return self.load_sample(index, rng)

    # ---- split filtering ----

    def _remove_invalid_idx(self, idx_list: List[str]) -> List[int]:
        """Drop frames with no in-boundary object of a known class
        (reference: kitti_dataset.py:178-198)."""
        kept = []
        bc = cnf.BOUNDARY
        for s in idx_list:
            sample_id = int(s)
            labels, no_obj = objects_to_bev_labels(self.get_label(sample_id))
            if no_obj:
                continue
            calib = self.get_calib(sample_id)
            labels[:, 1:] = camera_to_lidar_box(labels[:, 1:], V2C=calib.V2C, R0=calib.R0)
            xyz = labels[:, 1:4]
            valid = (
                (labels[:, 0] >= 0)
                & (xyz[:, 0] >= bc["minX"]) & (xyz[:, 0] <= bc["maxX"])
                & (xyz[:, 1] >= bc["minY"]) & (xyz[:, 1] <= bc["maxY"])
                & (xyz[:, 2] >= bc["minZ"]) & (xyz[:, 2] <= bc["maxZ"])
            )
            if np.any(valid):
                kept.append(sample_id)
        return kept
