"""Validation batches: seeded order, three layouts, a prefetch thread.

Counterpart of `BatchIterator` and `create_val_loader` of
`complex_yolov4_tpu/data/loader.py` (reference:
src/data_process/kitti_dataloader.py:50-61) for evaluation:

- a seeded per-epoch order (`shuffle`, `seed`, `set_epoch`);
  `drop_last=False` keeps the tail batch;
- fixed-shape numpy batches in one of three layouts: host-rastered images
  (`image`), deferred padded points for the device points raster
  (`points`, `point_mask`, `flip`, `holes`, `hole_mask`, `size`), or flat
  COO cells for the device COO raster (`cells`, `cell_keys`, `cell_dens`,
  `batch`, `batch_cap`); each with `targets` (B, T, 7), `target_mask`
  (B, T) and `sample_ids`;
- frames of a batch load on a thread pool that the iteration owns, and a
  background thread assembles the next batches while the consumer works.

Val frames are never resized or augmented, so the port needs no cv2; the
multiscale resize, the augmentations, the per-host shards and the batched
COO layout (for a data mesh) wait for the training and data-parallel
slices.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from . import bev as bev_mod
from .dataset import KittiDataset

# Static point padding for the device points raster: boundary-cropped KITTI /
# synthetic clouds stay under this.
MAX_POINTS = 20480
# Per-frame occupied-cell budget for the COO path: a cell needs at least one
# point, so cells <= points; synthetic scenes average ~12.6k cells/frame.
MAX_CELLS = 16384


class BatchIterator:
    """Deterministic epoch iterator over fixed-shape val batches."""

    def __init__(
        self,
        dataset: KittiDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 2020,
        prefetch: int = 2,
        device_raster: bool = False,
        cells_raster: bool = False,
        cell_capacity: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # device_raster: compact padded points instead of images (the
        # `from_points` program rasters on the device); cells_raster on top
        # of it: host-aggregated COO cells (the `from_cells` program)
        self.device_raster = device_raster
        self.cells_raster = cells_raster and device_raster
        # Per-frame COO cell capacity; None = derived from a workload sample
        # at first use (`_cells_per_frame_cap`)
        self.cell_capacity = cell_capacity
        self.seed = seed
        self.prefetch = prefetch  # batches assembled ahead; 0: no thread
        self.workers = min(8, os.cpu_count() or 4)
        self.epoch = 0
        self._warned_truncate = False
        self._warned_cell_truncate = False
        self._dropped_cells = 0

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
        """[fn(int(index)) for index in indices], on the pool when there is one."""
        if pool is not None and len(indices) > 1:
            return list(pool.map(lambda i: fn(int(i)), indices))
        return [fn(int(i)) for i in indices]

    def _load_one_deferred(self, index: int):
        """Device-raster sample: (points, pmask, targets, mask)."""
        _, lidar, targets, mask = self.dataset.load_sample(index, defer_raster=True)
        cropped = bev_mod.remove_points_outside(lidar)
        if cropped.shape[0] > MAX_POINTS and not self._warned_truncate:
            self._warned_truncate = True
            warnings.warn(
                f"device-raster path truncating {cropped.shape[0] - MAX_POINTS}"
                f" of {cropped.shape[0]} in-boundary points (cap {MAX_POINTS});"
                " dense frames will differ from the host raster",
                stacklevel=2)
        pts, pmask = bev_mod.pad_points(cropped, MAX_POINTS)
        return pts, pmask, targets, mask

    def _make_batch_deferred(self, indices: np.ndarray, pool) -> Dict[str, np.ndarray]:
        cols = list(zip(*self._map(pool, self._load_one_deferred, indices)))
        b = len(indices)
        return {
            "points": np.stack(cols[0]),
            "point_mask": np.stack(cols[1]),
            "flip": np.zeros((b,), np.float32),
            "holes": np.zeros((b, 1, 5), np.float32),   # val: no cutout
            "hole_mask": np.zeros((b, 1), np.float32),
            "targets": np.stack(cols[2]).astype(np.float32),
            "target_mask": np.stack(cols[3]).astype(np.float32),
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
            "size": int(self.dataset.img_size),
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
            c, _ = bev_mod.aggregate_bev_cells(
                bev_mod.remove_points_outside(lidar))
            worst = max(worst, len(c))
        self.cell_capacity = min(worst + worst // 8, MAX_CELLS)
        return self.cell_capacity

    def _make_batch_deferred_cells(self, indices: np.ndarray, pool) -> Dict[str, np.ndarray]:
        """COO val batch: per-cell (id, key, density) aggregated on the host,
        packed flat at the loader's full batch size and a fixed capacity, so
        a tail batch serves like a full one (its pad frames raster empty and
        the caller slices them off)."""
        def load_one(index):
            _, lidar, targets, mask = self.dataset.load_sample(index, defer_raster=True)
            c, k = bev_mod.aggregate_bev_cells(bev_mod.remove_points_outside(lidar))
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

    def _make_batch(self, indices: np.ndarray, pool) -> Dict[str, np.ndarray]:
        if self.device_raster and not self.dataset.is_test:
            if self.cells_raster:
                return self._make_batch_deferred_cells(indices, pool)
            return self._make_batch_deferred(indices, pool)
        results = self._map(pool, self.dataset.get_item, indices)
        image = np.empty((len(results),) + results[0][1].shape, np.float32)
        for j, (_, img, _, _) in enumerate(results):
            image[j] = img
        batch = {
            "image": image,
            "sample_ids": np.asarray(
                [self.dataset.sample_id_list[int(i)] for i in indices], np.int64),
        }
        if results[0][2] is not None:
            batch["targets"] = np.stack([r[2] for r in results]).astype(np.float32)
            batch["target_mask"] = np.stack([r[3] for r in results]).astype(np.float32)
        return batch

    def _iter_sync(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        pool = (ThreadPoolExecutor(max_workers=self.workers,
                                   thread_name_prefix="cyv4-torch-loader")
                if self.workers > 1 else None)
        try:
            for b in range(len(self)):
                chunk = indices[b * self.batch_size: (b + 1) * self.batch_size]
                yield self._make_batch(chunk, pool)
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
