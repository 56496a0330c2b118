"""Dataset/augmentation visualizer of the port (reference entry point
parity: src/data_process/kitti_dataloader.py:78-183 __main__).

Counterpart of `complex_yolov4_tpu/cli/visualize_dataset.py`, with the same
flags and output: draws ground-truth rotated boxes on augmented BEV samples
(mosaic supported) and writes them as images (or shows them with
--show); --html_3d also writes an interactive 3-D viewer per sample
(`utils/viewer_html.py`). Drawing needs OpenCV, which the module imports
only to draw: where `cv2` is missing, `main` raises before the first sample.

Usage:
    python -m complex_yolov4_tpu_torch.cli.visualize_dataset --synthetic --num 4 \\
        --output_dir /tmp/viz --mosaic
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.dataset import KittiDataset
from ..data.transforms import default_aug_transforms, default_lidar_transforms
from ..utils import visualization as viz
from . import common


def _require_cv2():
    """cv2, or an ImportError that says what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("visualize_dataset draws with OpenCV, and cv2 is not installed: "
                          "install opencv-python") from e
    return cv2


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("visualize_dataset")
    parser.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "val"])
    parser.add_argument("--num", type=int, default=4)
    parser.add_argument("--mosaic", action="store_true")
    parser.add_argument("--random_padding", action="store_true")
    parser.add_argument("--augment", action="store_true",
                        help="apply the training augmentation recipe")
    parser.add_argument("--output_dir", type=str, default="./viz_out")
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--html_3d", action="store_true",
                        help="also write an interactive 3-D HTML viewer "
                             "(raw cloud + GT boxes) per sample")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_frames", type=int, default=8)
    args = parser.parse_args(argv)
    cv2 = _require_cv2()

    dataset_dir = common.resolve_dataset_dir(args)
    ds = KittiDataset(
        dataset_dir, mode=args.mode,
        lidar_transforms=default_lidar_transforms() if args.augment else None,
        aug_transforms=default_aug_transforms() if args.augment else None,
        mosaic=args.mosaic, random_padding=args.random_padding)
    os.makedirs(args.output_dir, exist_ok=True)

    for k in range(min(args.num, len(ds))):
        rng = np.random.default_rng((args.seed, k))
        _, img, targets, mask = ds.get_item(k, rng)
        bev_img = viz.bev_to_uint8(img)
        viz.draw_targets_bev(bev_img, targets, mask, img.shape[0])
        bev_img = cv2.rotate(bev_img, cv2.ROTATE_180)
        out_path = os.path.join(args.output_dir, f"sample_{k:03d}.jpg")
        cv2.imwrite(out_path, bev_img)
        print(f"wrote {out_path} ({int(mask.sum())} boxes)")
        if args.html_3d and not args.mosaic:
            from ..data.kitti import objects_to_bev_labels
            from ..data.transforms import camera_to_lidar_box
            from ..utils.viewer_html import save_lidar_html
            sample_id = ds.sample_id_list[k]
            labels, no_obj = objects_to_bev_labels(ds.get_label(sample_id))
            calib = ds.get_calib(sample_id)
            boxes7 = np.zeros((0, 7))
            classes = np.zeros((0,))
            if not no_obj:
                boxes7 = camera_to_lidar_box(labels[:, 1:],
                                             V2C=calib.V2C, R0=calib.R0)
                boxes7[:, 2] += boxes7[:, 3] / 2.0  # bottom z -> center z
                classes = labels[:, 0]
            html_path = os.path.join(args.output_dir, f"sample_{k:03d}.html")
            save_lidar_html(ds.get_lidar(sample_id), html_path,
                            boxes_lidar=boxes7, box_classes=classes,
                            title=f"sample {sample_id:06d} — ground truth")
            print(f"wrote {html_path}")
        if args.show:
            cv2.imshow("dataset", bev_img)
            if cv2.waitKey(0) & 0xFF == 27:
                break


if __name__ == "__main__":
    main(sys.argv[1:])
