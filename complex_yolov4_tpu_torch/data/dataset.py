"""KITTI BEV dataset, val and test modes: file loading -> raster -> targets.

A copy of `KittiDataset` of `complex_yolov4_tpu/data/dataset.py` (reference:
src/data_process/kitti_dataset.py:29-121) in its val and test modes, with
`load_sample` and `load_bev_only`: the same split filtering, labels and
targets. The host raster is the numpy `bev.make_bev_map`, which the JAX
package's native C++ rasterizer equals bit for bit; the native copy, the
augmentations and mosaic wait for the training slice. With
`defer_raster=True` no image is built and the cloud comes back instead, for
the device rasters. `tests/test_torch_port_copies.py` holds the samples
equal to the original's.
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


class KittiDataset:
    """Indexable KITTI BEV dataset (val / test modes)."""

    def __init__(
        self,
        dataset_dir: str,
        mode: str = "val",
        num_samples: Optional[int] = None,
        max_targets: int = tgt_mod.MAX_TARGETS,
        img_size: int = cnf.BEV_WIDTH,
    ):
        if mode not in ("val", "test"):
            raise ValueError(f"invalid mode {mode!r}: the port reads val and test splits")
        self.dataset_dir = dataset_dir
        self.mode = mode
        self.is_test = mode == "test"
        self.paths = split_paths(dataset_dir, mode)
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

    def load_sample(self, index: int, defer_raster: bool = False):
        """(img_path, bev HWC, targets (T,7), mask (T,)) for one frame
        (reference: kitti_dataset.py:87-121); with `defer_raster=True` the
        (N, 4) lidar cloud stands where the raster would."""
        sample_id = self.sample_id_list[index]
        lidar = self.get_lidar(sample_id)
        calib = self.get_calib(sample_id)
        labels, no_obj = objects_to_bev_labels(self.get_label(sample_id))
        if not no_obj:
            labels[:, 1:] = camera_to_lidar_box(labels[:, 1:], V2C=calib.V2C, R0=calib.R0)
        img = lidar if defer_raster else bev_mod.make_bev_map(
            bev_mod.remove_points_outside(lidar))
        targets, mask = tgt_mod.build_yolo_targets(
            labels if not no_obj else np.zeros((0, 8), np.float32),
            max_targets=self.max_targets,
        )
        return self.get_image_path(sample_id), img, targets, mask

    def get_item(self, index: int):
        """(path, img, targets, mask); test mode has no targets (None)."""
        if self.is_test:
            path, img = self.load_bev_only(index)
            return path, img, None, None
        return self.load_sample(index)

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
