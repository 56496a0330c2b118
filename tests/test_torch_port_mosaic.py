"""Mosaic training data in the port against the JAX package's, on the CPU.

The same synthetic tree, augmentation recipe and (seed, epoch, index)
through both packages, on the fused native path (the port's library and
the JAX package's, both built from the same C++ source) and on the numpy
path (`CYV4_PYTHON_MOSAIC=1`, read by both):

- `KittiDataset(mosaic=True).get_item`: image paths, canvas, targets, masks
  and the RNG state after the draw, bit for bit;
- `create_train_loader(mosaic=True)` batches over two epochs, the JAX
  loader without its prefetch thread: every array bit for bit, except the
  numpy path's image, whose 2:1 resize is the port's `resize_linear` where
  the JAX loader calls cv2.resize: within 1e-6, the JAX package's own bound
  between its two mosaic paths (tests/test_native.py); the mosaic loaders
  of both packages turn the device raster and multiscale off;
- an image-space transform the probe cannot record takes the numpy path
  with the RNG rewound, in both packages alike.
"""

import shutil

import numpy as np
import pytest

from complex_yolov4_tpu import native as jnative
from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu.data import transforms as jtf
from complex_yolov4_tpu.data.dataset import KittiDataset as JDataset
from complex_yolov4_tpu_torch import native
from complex_yolov4_tpu_torch.data import loader as tloader
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.data import transforms as ttf
from complex_yolov4_tpu_torch.data.dataset import KittiDataset as TDataset
from tests._torch_port_util import capped_threads  # noqa: F401

AUG = dict(hflip_prob=0.5, cutout_prob=0.7, cutout_nholes=1, cutout_ratio=0.3,
           cutout_fill_value=0.25)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not shutil.which("g++") and not shutil.which("c++"):
        pytest.skip("no C++ compiler on PATH")
    native.build()  # raises on a failed build
    assert native.is_available() and jnative.is_available()
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=4, num_val=0, num_test=0,
        seed=8)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("CYV4_PYTHON_MOSAIC", "1")
    else:
        monkeypatch.delenv("CYV4_PYTHON_MOSAIC", raising=False)
    return request.param


def _datasets(root):
    kw = dict(mode="train", mosaic=True, random_padding=True)
    jd = JDataset(root, lidar_transforms=jtf.default_lidar_transforms(),
                  aug_transforms=jtf.default_aug_transforms(*AUG.values()), **kw)
    td = TDataset(root, lidar_transforms=ttf.default_lidar_transforms(),
                  aug_transforms=ttf.default_aug_transforms(*AUG.values()), **kw)
    return jd, td


def test_get_item_identical(root, path):
    jd, td = _datasets(root)
    assert jd.sample_id_list == td.sample_id_list and len(td) == 4
    for i in range(len(td)):
        jr, tr = np.random.default_rng((3, 1, i)), np.random.default_rng((3, 1, i))
        ja, ta = jd.get_item(i, jr), td.get_item(i, tr)
        assert ja[0] == ta[0] and len(ta[0]) == 4
        assert ta[1].shape == ((608, 608, 3) if path == "native" else (1216, 1216, 3))
        for a, b in zip(ja[1:], ta[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert jr.bit_generator.state == tr.bit_generator.state


def test_train_loader_batches_identical(root, path):
    kw = dict(num_samples=4, multiscale=True, mosaic=True, random_padding=True, seed=5,
              device_raster=True, **AUG)
    jl = jloader.create_train_loader(root, 2, **kw)
    tl = tloader.create_train_loader(root, 2, **kw)
    jl.prefetch = 0
    assert not (jl.device_raster or tl.device_raster or jl.multiscale or tl.multiscale)
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 2
        for jb, tb in zip(jbs, tbs):
            assert set(jb) == set(tb) == {"image", "targets", "target_mask", "sample_ids"}
            for k in jb:
                a, b = np.asarray(jb[k]), np.asarray(tb[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                if k == "image" and path == "numpy":
                    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=k)
            assert tb["image"].shape == (2, 608, 608, 3)
            assert tb["target_mask"].sum() > 0


def test_unrecordable_transform_takes_numpy_path(root):
    """A transform the probe cannot record: the numpy canvas, from the same
    rewound RNG stream, in both packages."""
    class Sepia:
        def __call__(self, rng, img, tm):
            return img * 0.9, tm

    jd, td = _datasets(root)
    jd.aug_transforms.transforms.append(Sepia())
    td.aug_transforms.transforms.append(Sepia())
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    ja, ta = jd.load_mosaic(1, jr), td.load_mosaic(1, tr)
    assert ta[1].shape == (1216, 1216, 3)
    for a, b in zip(ja[1:], ta[1:]):
        np.testing.assert_array_equal(a, b)
    assert jr.bit_generator.state == tr.bit_generator.state
