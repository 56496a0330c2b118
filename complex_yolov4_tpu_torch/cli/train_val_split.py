"""Train/val split tool (reference entry point parity:
src/data_process/train_val_split.py) — deterministic shuffle instead of
sklearn's.

A copy of `complex_yolov4_tpu/cli/train_val_split.py` (numpy only), held
to it by tests/test_torch_port_copies.py.

Usage:
    python -m complex_yolov4_tpu_torch.cli.train_val_split --dataset_dir D --num_ids 7481
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("train_val_split")
    parser.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    parser.add_argument("--num_ids", type=int, default=7481)
    parser.add_argument("--val_size", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    ids = rng.permutation(args.num_ids)
    n_val = int(round(args.num_ids * args.val_size))
    splits = {"val": np.sort(ids[:n_val]), "train": np.sort(ids[n_val:])}

    out_dir = os.path.join(args.dataset_dir, "ImageSets")
    os.makedirs(out_dir, exist_ok=True)
    for name, sel in splits.items():
        path = os.path.join(out_dir, f"{name}.txt")
        with open(path, "w") as f:
            f.write("\n".join(f"{i:06d}" for i in sel) + "\n")
        print(f"wrote {len(sel)} ids -> {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
