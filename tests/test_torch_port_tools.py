"""The port's tool CLIs against the JAX package's, on one synthetic tree.

- `find_anchors`: the same boxes (bit for bit: both datasets are copies)
  and the same anchors and average IoU within 1e-4 (the rotated IoU runs
  in f32 in both, its sums in another order), run through both CLIs with
  the same flags, the port's with ``--device cpu``; it raises without CUDA
  when ``--device cpu`` is not given.
- `train_val_split`: identical files.
- `visualize_dataset`: identical JPEG bytes (so the pixels are equal too)
  and HTML viewers, plain, with ``--augment`` and with ``--mosaic
  --augment``; with `cv2` blocked it raises before the first sample.
"""

import os
import sys

import numpy as np
import pytest
import torch

from complex_yolov4_tpu.cli import find_anchors as jfa
from complex_yolov4_tpu.cli import train_val_split as jtvs
from complex_yolov4_tpu.cli import visualize_dataset as jviz
from complex_yolov4_tpu.data.dataset import KittiDataset as JDataset
from complex_yolov4_tpu_torch.cli import find_anchors as tfa
from complex_yolov4_tpu_torch.cli import train_val_split as ttvs
from complex_yolov4_tpu_torch.cli import visualize_dataset as tviz
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.data.dataset import KittiDataset as TDataset
from tests._torch_port_util import capped_threads  # noqa: F401


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(str(tmp_path_factory.mktemp("kitti")),
                                            num_train=12, num_val=4, num_test=0, seed=5)


@pytest.mark.parametrize("keep_yaw", [False, True])
def test_find_anchors_equals_jax(root, capsys, keep_yaw):
    jboxes = jfa.collect_boxes(JDataset(root, mode="train"), 608, zero_yaw=not keep_yaw)
    tboxes = tfa.collect_boxes(TDataset(root, mode="train"), 608, zero_yaw=not keep_yaw)
    np.testing.assert_array_equal(tboxes, jboxes)
    assert len(tboxes) >= 20
    argv = (["--dataset_dir", root, "--num_anchors", "6", "--seed", "3"]
            + (["--keep_yaw"] if keep_yaw else []))
    jfa.main(argv)
    jout = capsys.readouterr().out
    anchors, avg_iou = tfa.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    janchors, javg = jfa.kmeans_anchors(jboxes, 6, 3)
    np.testing.assert_allclose(anchors, janchors, rtol=0, atol=1e-4)
    assert abs(avg_iou - javg) < 1e-4
    assert tout.splitlines()[0] == jout.splitlines()[0]  # "collected N boxes ..."
    assert len(tout.splitlines()) == len(jout.splitlines())


def test_find_anchors_needs_cuda_by_default(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tfa.main(["--dataset_dir", root])


def test_train_val_split_equals_jax(tmp_path, capsys):
    for mod, name in ((jtvs, "j"), (ttvs, "t")):
        mod.main(["--dataset_dir", str(tmp_path / name), "--num_ids", "103",
                  "--val_size", "0.3", "--seed", "9"])
    capsys.readouterr()
    for split in ("train", "val"):
        j = (tmp_path / "j" / "ImageSets" / f"{split}.txt").read_bytes()
        t = (tmp_path / "t" / "ImageSets" / f"{split}.txt").read_bytes()
        assert j == t and len(j) > 0


@pytest.mark.parametrize("flags", [[], ["--augment"], ["--mosaic", "--augment"]])
def test_visualize_dataset_equals_jax(root, tmp_path, flags, capsys):
    base = ["--dataset_dir", root, "--num", "3", "--seed", "2", "--html_3d"] + flags
    jviz.main(base + ["--output_dir", str(tmp_path / "j")])
    tviz.main(base + ["--output_dir", str(tmp_path / "t")])
    capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert sum(n.endswith(".jpg") for n in names) == 3
    assert sum(n.endswith(".html") for n in names) == (0 if "--mosaic" in flags else 3)
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == (tmp_path / "t" / n).read_bytes(), n


def test_visualize_dataset_raises_without_cv2(root, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="opencv"):
        tviz.main(["--dataset_dir", root, "--output_dir", str(tmp_path / "v")])
    assert not (tmp_path / "v").exists()
