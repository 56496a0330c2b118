"""KITTI BEV dataset: file loading -> augmentation -> raster -> targets.

A copy of `KittiDataset` of `complex_yolov4_tpu/data/dataset.py` (reference:
src/data_process/kitti_dataset.py:29-253) in its train, val and test
modes: the same split filtering, labels, targets, augmentations with an
explicit `np.random.Generator`, host rasters and 4-frame mosaic. The host
raster takes the port's native C++ rasterizer (`native/`) where it builds
and the numpy `bev.make_bev_map` otherwise; the two are equal bit for bit.
With `defer_raster=True` no image is built: an `_AugProbe` records the flip
and cutout decisions from the same random draws, and the augmented cloud
comes back beside it, for the device rasters and the fused native mosaic.
`tests/test_torch_port_copies.py` holds the methods and the samples equal
to the original's.
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
        random_padding: bool = False,
        max_targets: int = tgt_mod.MAX_TARGETS,
        img_size: int = cnf.BEV_WIDTH,
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"invalid mode {mode!r}")
        self.dataset_dir = dataset_dir
        self.mode = mode
        self.is_test = mode == "test"
        self.paths = split_paths(dataset_dir, mode)
        self.lidar_transforms = lidar_transforms
        self.aug_transforms = aug_transforms
        self.mosaic = mosaic
        self.random_padding = random_padding
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
        """Test mode: BEV raster only (reference: kitti_dataset.py:76-85).

        Uses the native C++ rasterizer when built (bit-identical output);
        falls back to the numpy path otherwise.
        """
        sample_id = self.sample_id_list[index]
        lidar_path = os.path.join(self.paths["lidar"], f"{sample_id:06d}.bin")
        from .. import native

        if native.is_available():
            return self.get_image_path(sample_id), native.rasterize_files([lidar_path])[0]
        cropped = bev_mod.remove_points_outside(read_velodyne(lidar_path))
        return self.get_image_path(sample_id), bev_mod.make_bev_map(cropped)

    def load_sample(self, index: int, rng: Optional[np.random.Generator] = None,
                    defer_raster: bool = False):
        """(img_path, bev HWC, targets (T,7), mask (T,)) for one frame
        (reference: kitti_dataset.py:87-121).

        With `defer_raster=True` (fused native mosaic) no image is built:
        `img` comes back as ``(_AugProbe, points)`` — the augmentation
        decisions plus the post-transform points — while the RNG stream and
        target processing stay bit-identical to the normal path.
        """
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
            from .. import native

            if native.is_available():
                img = native.rasterize_points(lidar)  # bit-identical to numpy
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

    def load_mosaic(self, index: int, rng: np.random.Generator):
        """4-frame mosaic (reference: kitti_dataset.py:123-175).

        Dispatches to the fused native path (C++: raster + flip/cutout +
        placement + 2:1 resize in one pass, returning the final S x S canvas)
        when available; otherwise builds the 2S x 2S canvas in numpy and the
        caller resizes back to S. Both paths consume the identical RNG
        stream, so a given (seed, epoch, index) yields the same sample
        (fused: bit-equal points/targets, canvas equal to the numpy canvas
        after the loader's 2:1 `resize_linear`;
        tests/test_torch_port_native.py enforces)."""
        from .. import native

        if (native.is_available() and self.img_size == cnf.BEV_WIDTH
                and not os.environ.get("CYV4_PYTHON_MOSAIC")):
            state = rng.bit_generator.state
            try:
                return self._load_mosaic_native(index, rng)
            except (TypeError, AttributeError, NotImplementedError):
                # a custom image-space transform the probe can't record —
                # rewind the RNG and take the numpy path
                rng.bit_generator.state = state
        return self._load_mosaic_python(index, rng)

    def _load_mosaic_native(self, index: int, rng: np.random.Generator):
        from .. import native

        s = self.img_size
        if self.random_padding:
            yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
        else:
            yc, xc = s, s

        indices = [index] + [int(rng.integers(0, len(self))) for _ in range(3)]
        img_paths = []
        pts_list, flips, holes_list = [], [], []
        all_t: List[np.ndarray] = []
        for i, idx in enumerate(indices):
            path, (probe, pts), targets, mask = self.load_sample(
                idx, rng, defer_raster=True)
            img_paths.append(path)
            pts_list.append(pts)
            flips.append(probe.flipped)
            holes_list.append(probe.holes)
            h, w = probe.shape[0], probe.shape[1]
            if i == 0:    # top left
                x1a, y1a = max(xc - w, 0), max(yc - h, 0)
                x1b, y1b = w - (xc - x1a), h - (yc - y1a)
            elif i == 1:  # top right
                x1a, y1a = xc, max(yc - h, 0)
                x1b, y1b = 0, h - (yc - y1a)
            elif i == 2:  # bottom left
                x1a, y1a = max(xc - w, 0), yc
                x1b, y1b = w - (xc - x1a), 0
            else:         # bottom right
                x1a, y1a = xc, yc
                x1b, y1b = 0, 0
            padw, padh = x1a - x1b, y1a - y1b

            t = targets.copy()
            live = mask > 0
            t[live, 1] = (t[live, 1] * w + padw) / (2 * s)
            t[live, 2] = (t[live, 2] * h + padh) / (2 * s)
            t[live, 3] = t[live, 3] * w / (2 * s)
            t[live, 4] = t[live, 4] * h / (2 * s)
            all_t.append(t[live])

        canvas = native.mosaic_rasterize(pts_list, flips, holes_list, yc, xc)
        merged = (np.concatenate(all_t, axis=0) if all_t
                  else np.zeros((0, 7), np.float32))
        merged[:, 1:3] = np.clip(merged[:, 1:3], 0.0, 1.0 - 0.5 / s)
        n = min(merged.shape[0], self.max_targets)
        targets = np.zeros((self.max_targets, 7), np.float32)
        mask = np.zeros((self.max_targets,), np.float32)
        targets[:n] = merged[:n]
        mask[:n] = 1.0
        return img_paths, canvas, targets, mask

    def _load_mosaic_python(self, index: int, rng: np.random.Generator):
        """4-frame mosaic on a 2S x 2S canvas filled 0.5, then the caller
        resizes back to S (reference: kitti_dataset.py:123-175)."""
        s = self.img_size
        if self.random_padding:
            yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
        else:
            yc, xc = s, s

        canvas = np.full((2 * s, 2 * s, 3), 0.5, np.float32)
        all_t = []
        all_m = []
        indices = [index] + [int(rng.integers(0, len(self))) for _ in range(3)]
        img_paths = []
        for i, idx in enumerate(indices):
            path, img, targets, mask = self.load_sample(idx, rng)
            img_paths.append(path)
            h, w = img.shape[0], img.shape[1]
            if i == 0:    # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
                x1b, y1b = 0, h - (y2a - y1a)
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
            else:         # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
                x1b, y1b = 0, 0
            x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b

            t = targets.copy()
            live = mask > 0
            t[live, 1] = (t[live, 1] * w + padw) / (2 * s)
            t[live, 2] = (t[live, 2] * h + padh) / (2 * s)
            t[live, 3] = t[live, 3] * w / (2 * s)
            t[live, 4] = t[live, 4] * h / (2 * s)
            all_t.append(t[live])
            all_m.append(np.ones(int(live.sum()), np.float32))

        merged = np.concatenate(all_t, axis=0) if all_t else np.zeros((0, 7), np.float32)
        merged[:, 1:3] = np.clip(merged[:, 1:3], 0.0, 1.0 - 0.5 / s)
        n = min(merged.shape[0], self.max_targets)
        targets = np.zeros((self.max_targets, 7), np.float32)
        mask = np.zeros((self.max_targets,), np.float32)
        targets[:n] = merged[:n]
        mask[:n] = 1.0
        return img_paths, canvas, targets, mask

    def get_item(self, index: int, rng: Optional[np.random.Generator] = None):
        """Uniform entry point: returns (paths, img, targets, mask); img is
        (2S, 2S, 3) for mosaic samples (resized by the batcher), else (S, S, 3)."""
        if self.is_test:
            path, img = self.load_bev_only(index)
            return path, img, None, None
        if self.mosaic:
            rng = rng or np.random.default_rng()
            return self.load_mosaic(index, rng)
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
