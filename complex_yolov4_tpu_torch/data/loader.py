"""Train, validation and test batches: seeded order, three layouts, a
prefetch thread.

Counterpart of `BatchIterator`, `create_train_loader`, `create_val_loader`
and `create_test_loader` of `complex_yolov4_tpu/data/loader.py`
(reference: src/data_process/kitti_dataloader.py:22-76):

- a seeded per-epoch order (`shuffle`, `seed`, `set_epoch`); each sample's
  augmentations draw from `default_rng((seed, epoch, index, slot))`, so a
  batch is the JAX loader's for the same seed and epoch;
- fixed-shape numpy batches in one of three layouts: host-rastered images
  (`image`), deferred padded points and the recorded flip and cutout
  decisions for the device points raster (`points`, `point_mask`, `flip`,
  `holes`, `hole_mask`, `size`), or flat COO cells for the device COO
  raster (`cells`, `cell_keys`, `cell_dens`, `batch`, `batch_cap`; val
  only); each with `targets` (B, T, 7), `target_mask` (B, T) and
  `sample_ids`; a deferred test batch carries the padded points and the
  host-rastered `image` for drawing, and no targets;
- host COO cells and host rasters come from the native C++ rasterizer
  (`native/`) where it builds, else from the numpy functions it equals;
- mosaic training (4 frames on a 2S x 2S canvas, resized back to S here,
  or the fused native mosaic, already at S) rasters on the host and turns
  the device raster and multiscale off, as the JAX loader does;
- multiscale training: a new size from {S-96 .. S+96 step 32} every 10
  batches, seeded per epoch (reference: kitti_dataset.py:216-235); the
  device raster resizes, a host-rastered image is resized here by
  `resize_linear` (cv2's INTER_LINEAR sampling, in numpy: the port needs no
  cv2);
- frames of a batch load on a thread pool that the iteration owns, and a
  background thread assembles the next batches while the consumer works;
  its end-of-data mark waits for room like a batch.

The per-host shards and the batched COO layout (for a data mesh) wait for
the data-parallel slice.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .. import native
from . import bev as bev_mod
from .dataset import KittiDataset, _ProbeUnsupported
from .transforms import default_aug_transforms, default_lidar_transforms

_MULTISCALE_EVERY = 10  # batches between size redraws (reference parity)

# Static point padding for the device points raster: boundary-cropped KITTI /
# synthetic clouds stay under this.
MAX_POINTS = 20480
# Per-frame occupied-cell budget for the COO path: a cell needs at least one
# point, so cells <= points; synthetic scenes average ~12.6k cells/frame.
MAX_CELLS = 16384


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) f32 -> (size, size, C): bilinear with half-pixel centres
    and edge clamping, the sampling of cv2.resize(INTER_LINEAR) on f32
    images (the JAX loader's multiscale and mosaic resize), within 1.2e-7
    of cv2's values in [0, 1]. At exactly 2:1 (a mosaic canvas) each output
    is the two-tap expression of the fused native mosaic
    (`bev_native.cpp::mosaic`: the two rows' horizontal halves, then their
    vertical half), so that the numpy mosaic equals the native one bit for
    bit."""
    if img.shape[0] == img.shape[1] == 2 * size:
        h = np.float32(0.5)
        a0, a1 = img[0::2, 0::2], img[0::2, 1::2]
        b0, b1 = img[1::2, 0::2], img[1::2, 1::2]
        return ((a0 * h + a1 * h) * h + (b0 * h + b1 * h) * h).astype(np.float32)

    def taps(n_in: int):
        src = np.maximum((np.arange(size) + 0.5) * (n_in / size) - 0.5, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (src - i0).astype(np.float32)

    y0, y1, fy = taps(img.shape[0])
    x0, x1, fx = taps(img.shape[1])
    rows = img[y0] * (1.0 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    out = rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return out.astype(np.float32)


def _aggregate(lidar: np.ndarray):
    """Host COO cells of a raw cloud: (cells, keys) of
    `bev.aggregate_bev_cells(bev.remove_points_outside(lidar))`, from the
    native library where it builds (bit-identical)."""
    if native.is_available():
        return native.aggregate_cells(lidar)
    return bev_mod.aggregate_bev_cells(bev_mod.remove_points_outside(lidar))


class BatchIterator:
    """Deterministic epoch iterator over fixed-shape batches."""

    def __init__(
        self,
        dataset: KittiDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        multiscale: bool = False,
        seed: int = 2020,
        prefetch: int = 2,
        device_raster: bool = False,
        max_holes: int = 1,
        cells_raster: bool = False,
        cell_capacity: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # mosaic samples are rastered on the host (their canvas resize is an
        # image-space op) at the native size, as the JAX loader's
        self.multiscale = multiscale and not dataset.mosaic
        # cutout holes a deferred batch carries per frame
        self.max_holes = max_holes
        # device_raster: compact padded points instead of images (the
        # `from_points` program rasters on the device); cells_raster on top
        # of it: host-aggregated COO cells (the `from_cells` program)
        self.device_raster = device_raster and not dataset.mosaic
        self.cells_raster = cells_raster and device_raster
        # Per-frame COO cell capacity; None = derived from a workload sample
        # at first use (`_cells_per_frame_cap`)
        self.cell_capacity = cell_capacity
        self.seed = seed
        self.prefetch = prefetch  # batches assembled ahead; 0: no thread
        self.workers = min(8, os.cpu_count() or 4)
        self.epoch = 0
        self._warned_truncate = False
        self._warned_holes = False
        self._warned_fallback = False
        self._warned_cell_truncate = False
        self._dropped_cells = 0
        base = dataset.img_size
        self.size_choices = list(range(base - 3 * 32, base + 3 * 32 + 1, 32))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(n) if self.shuffle else np.arange(n)

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _map(self, pool: Optional[ThreadPoolExecutor], fn, indices):
        """[fn(int(index), slot) for slot, index in enumerate(indices)], on
        the pool when there is one."""
        if pool is not None and len(indices) > 1:
            return list(pool.map(lambda ji: fn(int(ji[1]), ji[0]), enumerate(indices)))
        return [fn(int(i), j) for j, i in enumerate(indices)]

    def _rng(self, index: int, j: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, int(index), j))

    def _load_one(self, index: int, j: int, size: int):
        _, img, targets, mask = self.dataset.get_item(index, self._rng(index, j))
        if img.shape[0] != size:
            img = resize_linear(img, size)
        return img, targets, mask

    def _load_one_deferred(self, index: int, j: int):
        """Device-raster sample: (points, pmask, flip, holes, hole_mask,
        targets, mask), from the same random draws as `_load_one` (the
        transforms run; only the pixel work is left to the device)."""
        _, (probe, lidar), targets, mask = self.dataset.load_sample(
            index, self._rng(index, j), defer_raster=True)
        cropped = bev_mod.remove_points_outside(lidar)
        if cropped.shape[0] > MAX_POINTS and not self._warned_truncate:
            self._warned_truncate = True
            warnings.warn(
                f"device-raster path truncating {cropped.shape[0] - MAX_POINTS}"
                f" of {cropped.shape[0]} in-boundary points (cap {MAX_POINTS});"
                " dense frames will differ from the host raster",
                stacklevel=2)
        pts, pmask = bev_mod.pad_points(cropped, MAX_POINTS)
        if len(probe.holes) > self.max_holes and not self._warned_holes:
            self._warned_holes = True
            warnings.warn(
                f"device-raster path dropping {len(probe.holes) - self.max_holes}"
                f" cutout hole(s) beyond max_holes={self.max_holes}; pass"
                " max_holes >= cutout n_holes to BatchIterator", stacklevel=2)
        holes = np.zeros((self.max_holes, 5), np.float32)
        hole_mask = np.zeros((self.max_holes,), np.float32)
        for h, hole in enumerate(probe.holes[: self.max_holes]):
            holes[h] = hole
            hole_mask[h] = 1.0
        return (pts, pmask, np.float32(probe.flipped), holes, hole_mask, targets, mask)

    def _make_batch_deferred(self, indices: np.ndarray, pool, size: int):
        """A deferred batch; None when an image-space transform does what
        the probe cannot record (the caller then rasters on the host)."""
        try:
            results = self._map(pool, self._load_one_deferred, indices)
        except (_ProbeUnsupported, TypeError, AttributeError, NotImplementedError) as e:
            # the JAX loader's catch set: a custom transform's array op on
            # the probe raises a plain TypeError or AttributeError. Warned
            # (once), so that a fault of the deferred path does not pass unseen.
            if not self._warned_fallback:
                self._warned_fallback = True
                warnings.warn(f"deferred batch unavailable ({type(e).__name__}: {e}); such "
                              "batches are rastered on the host", stacklevel=2)
            return None
        cols = list(zip(*results))
        return {
            "points": np.stack(cols[0]),
            "point_mask": np.stack(cols[1]),
            "flip": np.asarray(cols[2], np.float32),
            "holes": np.stack(cols[3]),
            "hole_mask": np.stack(cols[4]),
            "targets": np.stack(cols[5]).astype(np.float32),
            "target_mask": np.stack(cols[6]).astype(np.float32),
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
            "size": int(size),
        }

    def _cells_per_frame_cap(self) -> int:
        """Per-frame COO cell capacity, derived from the workload once: the
        max occupied-cell count over a small evenly-spaced frame sample,
        +12.5% headroom, clamped to MAX_CELLS. Frames beyond the estimate
        surface through the dropped-cell warning/count rather than
        silently."""
        if self.cell_capacity is not None:
            return self.cell_capacity
        n = len(self.dataset)
        sample = np.unique(np.linspace(0, n - 1, min(16, n)).astype(int))
        worst = 1024
        for i in sample:
            lidar = self.dataset.get_lidar(self.dataset.sample_id_list[int(i)])
            worst = max(worst, len(_aggregate(lidar)[0]))
        self.cell_capacity = min(worst + worst // 8, MAX_CELLS)
        return self.cell_capacity

    def _make_batch_deferred_cells(self, indices: np.ndarray, pool) -> Dict[str, np.ndarray]:
        """COO val batch: per-cell (id, key, density) aggregated on the host,
        packed flat at the loader's full batch size and a fixed capacity, so
        a tail batch serves like a full one (its pad frames raster empty and
        the caller slices them off)."""
        def load_one(index, j):
            _, (_, lidar), targets, mask = self.dataset.load_sample(
                index, self._rng(index, j), defer_raster=True)
            c, k = _aggregate(lidar)
            return c, k, targets, mask

        cells_l, keys_l, tgts, masks = zip(*self._map(pool, load_one, indices))
        per_frame = self._cells_per_frame_cap()
        cap = self.batch_size * per_frame
        dropped = max(0, sum(len(c) for c in cells_l) - cap)
        cells, keys, dens = bev_mod.pack_cells_flat(
            list(cells_l), list(keys_l), cap, total_frames=self.batch_size)
        if dropped:
            self._dropped_cells += dropped
            if not self._warned_cell_truncate:
                self._warned_cell_truncate = True
                warnings.warn(
                    f"cells-raster path dropping {dropped} occupied cells "
                    f"this batch (per-frame capacity {per_frame}); total "
                    "dropped is reported at iterator exhaustion — pass "
                    "cell_capacity to raise the cap", stacklevel=2)
        return {
            "cells": cells, "cell_keys": keys, "cell_dens": dens,
            "batch": len(indices), "batch_cap": self.batch_size,
            "targets": np.stack(tgts).astype(np.float32),
            "target_mask": np.stack(masks).astype(np.float32),
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
        }

    def _make_batch_deferred_test(self, indices: np.ndarray, pool) -> Dict[str, np.ndarray]:
        """Test-mode deferred batch: padded points for the `from_points`
        inference program, plus the host-rastered BEV image for drawing."""
        def load_one(index, j):
            lidar = self.dataset.get_lidar(self.dataset.sample_id_list[index])
            cropped = bev_mod.remove_points_outside(lidar)
            pts, msk = bev_mod.pad_points(cropped, MAX_POINTS)
            img = (native.rasterize_points(lidar) if native.is_available()
                   else bev_mod.make_bev_map(cropped))
            return pts, msk, img

        pts, msk, imgs = zip(*self._map(pool, load_one, indices))
        b = len(indices)
        return {
            "points": np.stack(pts), "point_mask": np.stack(msk),
            "flip": np.zeros((b,), np.float32),
            "holes": np.zeros((b, 1, 5), np.float32),
            "hole_mask": np.zeros((b, 1), np.float32),
            "image": np.stack(imgs).astype(np.float32),
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
        }

    def _make_batch(self, indices: np.ndarray, pool, size: int) -> Dict[str, np.ndarray]:
        if self.device_raster:
            if self.cells_raster and not self.dataset.is_test:
                return self._make_batch_deferred_cells(indices, pool)
            if self.dataset.is_test:
                return self._make_batch_deferred_test(indices, pool)
            batch = self._make_batch_deferred(indices, pool, size)
            if batch is not None:
                return batch
        results = self._map(pool, lambda i, j: self._load_one(i, j, size), indices)
        image = np.empty((len(results),) + results[0][0].shape, np.float32)
        for j, (img, _, _) in enumerate(results):
            image[j] = img
        batch = {
            "image": image,
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
        }
        if results[0][1] is not None:
            batch["targets"] = np.stack([r[1] for r in results]).astype(np.float32)
            batch["target_mask"] = np.stack([r[2] for r in results]).astype(np.float32)
        return batch

    def _iter_sync(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        pool = (ThreadPoolExecutor(max_workers=self.workers,
                                   thread_name_prefix="cyv4-torch-loader")
                if self.workers > 1 else None)
        size_rng = np.random.default_rng((self.seed, self.epoch, 7919))
        size = self.dataset.img_size
        try:
            for b in range(len(self)):
                if self.multiscale and b % _MULTISCALE_EVERY == 0:
                    size = int(size_rng.choice(self.size_choices))
                chunk = indices[b * self.batch_size: (b + 1) * self.batch_size]
                yield self._make_batch(chunk, pool, size)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        if self._dropped_cells:
            # Systematic truncation silently biases eval — surface the epoch
            # total (the first occurrence already warned with the cap).
            warnings.warn(
                f"cells-raster path dropped {self._dropped_cells} occupied "
                "cells total this epoch (per-frame capacity "
                f"{self.cell_capacity}); results are biased — raise "
                "cell_capacity", stacklevel=2)
            self._dropped_cells = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that notices the consumer leaving (a plain put
            would block forever once it stops reading); False if it left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                batches = self._iter_sync()
                try:
                    for item in batches:
                        if not put(item):
                            return
                finally:
                    batches.close()  # shuts the frame pool down
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                # the end-of-data mark waits for room like a batch: dropped
                # on a full queue, it would leave a slower consumer waiting
                # forever after the last batch
                put(sentinel)
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            # generator closed early (break / GC): unblock and join the
            # producer so no thread or buffered batch outlives the loop
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)


def create_val_loader(dataset_dir: str, batch_size: int, *,
                      num_samples: Optional[int] = None,
                      device_raster: bool = False,
                      cells_raster: bool = False,
                      cell_capacity: Optional[int] = None) -> BatchIterator:
    """Validation pipeline: no augmentation, no multiscale, the tail batch
    kept (reference: kitti_dataloader.py:50-61).

    device_raster: emit compact padded points instead of host-rastered
    images, for the `from_points` inference program. cells_raster (with
    device_raster): emit host-aggregated flat COO cells for the `from_cells`
    program; `cell_capacity` pins the per-frame cell budget (default:
    derived from a workload sample)."""
    ds = KittiDataset(dataset_dir, mode="val", num_samples=num_samples)
    return BatchIterator(ds, batch_size, shuffle=False, drop_last=False,
                         device_raster=device_raster, cells_raster=cells_raster,
                         cell_capacity=cell_capacity)


def create_train_loader(dataset_dir: str, batch_size: int, *,
                        num_samples: Optional[int] = None,
                        multiscale: bool = False, mosaic: bool = False,
                        random_padding: bool = False, seed: int = 2020,
                        hflip_prob: float = 0.5, cutout_prob: float = 0.0,
                        cutout_nholes: int = 1, cutout_ratio: float = 0.3,
                        cutout_fill_value: float = 0.0,
                        device_raster: bool = False) -> BatchIterator:
    """Training pipeline with the reference augmentation recipe, shuffled per
    epoch, the tail dropped (reference: kitti_dataloader.py:22-47). Mosaic
    samples are rastered on the host (the fused native mosaic where it
    builds), so `mosaic` turns `device_raster` and `multiscale` off."""
    ds = KittiDataset(
        dataset_dir, mode="train",
        lidar_transforms=default_lidar_transforms(),
        aug_transforms=default_aug_transforms(
            hflip_prob, cutout_prob, cutout_nholes, cutout_ratio, cutout_fill_value),
        num_samples=num_samples, mosaic=mosaic, random_padding=random_padding,
    )
    return BatchIterator(ds, batch_size, shuffle=True, drop_last=True, multiscale=multiscale,
                         seed=seed, device_raster=device_raster,
                         max_holes=max(cutout_nholes, 1))


def create_test_loader(dataset_dir: str, batch_size: int, *,
                       num_samples: Optional[int] = None,
                       device_raster: bool = False) -> BatchIterator:
    """Test/demo pipeline: BEV only, no targets, the tail batch kept, no
    prefetch thread (reference: kitti_dataloader.py:64-76).

    device_raster: also emit compact padded points so inference can raster
    on the device (`from_points`); the host image stays in the batch for
    drawing."""
    ds = KittiDataset(dataset_dir, mode="test", num_samples=num_samples)
    return BatchIterator(ds, batch_size, shuffle=False, drop_last=False,
                         prefetch=0, device_raster=device_raster)
