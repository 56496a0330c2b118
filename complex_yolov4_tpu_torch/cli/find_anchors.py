"""Anchor k-means tool of the port (reference entry point parity:
src/utils/find_anchors.py).

Counterpart of `complex_yolov4_tpu/cli/find_anchors.py`: the same flags and
output, plus ``--device`` (default ``cuda``; raises without CUDA unless
``--device cpu``). Clusters BEV ground-truth boxes (w, l, yaw) under
rotated-IoU distance (1 - IoU at a fixed center); each assignment step is
one `rotated_boxes.pairwise_rotated_iou` call over the full boxes x
centroids matrix on the device.

Usage (on the CPU):
    python -m complex_yolov4_tpu_torch.cli.find_anchors --synthetic --num_anchors 9 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..data.dataset import KittiDataset
from ..ops import rotated_boxes as rb
from . import common

def collect_boxes(dataset: KittiDataset, img_size: int, zero_yaw: bool) -> np.ndarray:
    """(N, 3) [w, l, yaw] of all train targets in input pixels."""
    rows = []
    for i in range(len(dataset)):
        _, _, targets, mask = dataset.load_sample(i, np.random.default_rng(0))
        for t in targets[mask > 0.5]:
            yaw = 0.0 if zero_yaw else float(np.arctan2(t[5], t[6]))
            rows.append([t[3] * img_size, t[4] * img_size, yaw])
    return np.asarray(rows, np.float32)


def iou_to_centroids(boxes: np.ndarray, centroids: np.ndarray, *,
                     device: torch.device) -> np.ndarray:
    """(N, K) rotated IoU of boxes vs centroids at a common fixed center,
    computed on `device`."""
    def to5(a):
        z = np.zeros((a.shape[0], 2), np.float32)
        return torch.from_numpy(np.concatenate([z, a], axis=1)).to(device)

    return rb.pairwise_rotated_iou(to5(boxes), to5(centroids)).cpu().numpy()


def kmeans_anchors(boxes: np.ndarray, k: int, seed: int = 0,
                   max_iters: int = 100, *, device: torch.device):
    """IoU-distance k-means (reference: find_anchors.py:63-120 semantics)."""
    rng = np.random.default_rng(seed)
    centroids = boxes[rng.choice(boxes.shape[0], k, replace=False)].copy()
    assign = np.full(boxes.shape[0], -1)
    for _ in range(max_iters):
        iou = iou_to_centroids(boxes, centroids, device=device)
        new_assign = iou.argmax(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = boxes[assign == j]
            if members.shape[0]:
                centroids[j] = members.mean(axis=0)
    avg_iou = float(iou_to_centroids(boxes, centroids, device=device)[
        np.arange(boxes.shape[0]), assign].mean())
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], avg_iou


def main(argv=None):
    """Run the tool; returns (anchors (K, 3), avg IoU)."""
    parser = argparse.ArgumentParser("find_anchors")
    parser.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    parser.add_argument("--num_anchors", type=int, default=9)
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--keep_yaw", action="store_true",
                        help="cluster with true yaw instead of forcing 0 "
                             "(the reference forces yaw=0, find_anchors.py:44)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_frames", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)

    device = common.resolve_device(args)
    dataset_dir = common.resolve_dataset_dir(args)
    ds = KittiDataset(dataset_dir, mode="train", num_samples=args.num_samples)
    boxes = collect_boxes(ds, args.img_size, zero_yaw=not args.keep_yaw)
    print(f"collected {boxes.shape[0]} boxes from {len(ds)} frames")
    anchors, avg_iou = kmeans_anchors(boxes, args.num_anchors, args.seed, device=device)
    print(f"avg IoU: {avg_iou * 100:.2f}%")
    print("anchors (w, l, yaw):")
    for a in anchors:
        print(f"  {a[0]:6.1f}, {a[1]:6.1f}, {a[2]:5.2f}")
    return anchors, avg_iou


if __name__ == "__main__":
    main(sys.argv[1:])
