"""The port's train data path vs the JAX package's, on the CPU.

The same synthetic KITTI tree (the port's generator, byte-identical to
the JAX one: test_torch_port_copies.py) read by both packages' train
loaders with the same seed and epoch:

- train samples (`KittiDataset(mode="train")` with the reference
  augmentations, cutout on): host rasters, targets and masks bit-equal,
  and with `defer_raster=True` the recorded flip and holes and the
  augmented cloud equal;
- train batches in the device-raster layout (points, flip, holes,
  targets; multiscale on) and the host-raster layout (images) equal to
  the JAX loader's, with the JAX loader read without its prefetch thread
  (`prefetch = 0`: its end-of-data mark can be lost, ROADMAP.md §3); the
  multiscale host resize (`resize_linear`, numpy) against the JAX
  loader's cv2.resize within 1e-5 (one f32 rounding per tap);
- a mosaic train loader turns the device raster and multiscale off, as
  the JAX loader does, and yields host-rastered 608 images (its batches
  against the JAX loader's: test_torch_port_mosaic.py).
"""

import numpy as np
import pytest

from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu.data import transforms as jtf
from complex_yolov4_tpu.data.dataset import KittiDataset as JDataset
from complex_yolov4_tpu_torch.data import loader as tloader
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.data import transforms as ttf
from complex_yolov4_tpu_torch.data.dataset import KittiDataset as TDataset
from tests._torch_port_util import capped_threads  # noqa: F401

AUG = dict(hflip_prob=0.5, cutout_prob=0.7, cutout_nholes=2, cutout_ratio=0.3,
           cutout_fill_value=0.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=6, num_val=0, num_test=0,
        seed=5)


def _datasets(root):
    jd = JDataset(root, mode="train", lidar_transforms=jtf.default_lidar_transforms(),
                  aug_transforms=jtf.default_aug_transforms(*AUG.values()))
    td = TDataset(root, mode="train", lidar_transforms=ttf.default_lidar_transforms(),
                  aug_transforms=ttf.default_aug_transforms(*AUG.values()))
    return jd, td


def test_train_samples_identical(root, monkeypatch):
    from complex_yolov4_tpu import native

    monkeypatch.setattr(native, "is_available", lambda: False)  # the numpy raster
    jd, td = _datasets(root)
    assert jd.sample_id_list == td.sample_id_list and len(td) == 6
    for i in range(len(td)):
        for defer in (False, True):
            ja = jd.load_sample(i, np.random.default_rng((1, i)), defer_raster=defer)
            ta = td.load_sample(i, np.random.default_rng((1, i)), defer_raster=defer)
            assert ja[0] == ta[0]
            if defer:
                (jp, jpts), (tp, tpts) = ja[1], ta[1]
                assert (jp.flipped, jp.holes) == (tp.flipped, tp.holes)
                np.testing.assert_array_equal(jpts, tpts)
            else:
                np.testing.assert_array_equal(ja[1], ta[1])
            for a, b in zip(ja[2:], ta[2:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device_raster,multiscale", [(True, True), (False, False)],
                         ids=["points_multiscale", "image"])
def test_train_batches_identical(root, monkeypatch, device_raster, multiscale):
    from complex_yolov4_tpu import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    kw = dict(num_samples=6, multiscale=multiscale, seed=3, device_raster=device_raster, **AUG)
    jl = jloader.create_train_loader(root, 2, **kw)
    tl = tloader.create_train_loader(root, 2, **kw)
    jl.prefetch = 0
    assert len(jl) == len(tl) == 3 and jl.size_choices == tl.size_choices
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 3
        for jb, tb in zip(jbs, tbs):
            assert set(jb) == set(tb)
            for k in jb:
                a, b = np.asarray(jb[k]), np.asarray(tb[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_resize_linear_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).uniform(0, 1, (608, 608, 3)).astype(np.float32)
    for size in (512, 576, 640, 704):
        ref = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        got = tloader.resize_linear(img, size)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5


def test_mosaic_raises(root):
    """Mosaic no longer raises: the loader rasters its samples on the host
    at the native size (no device raster, no multiscale)."""
    loader = tloader.create_train_loader(root, 2, mosaic=True, multiscale=True,
                                         device_raster=True, num_samples=2)
    assert not loader.device_raster and not loader.multiscale
    loader.prefetch = 0
    batch = next(iter(loader))
    assert batch["image"].shape == (2, 608, 608, 3) and batch["image"].dtype == np.float32
    assert batch["targets"].shape == (2, 64, 7) and "points" not in batch


def test_deferred_fallback_warns(root, monkeypatch):
    """An image-space transform whose array op the aug probe cannot record
    (here a scaling, a plain TypeError on the probe) sends the batch to the
    host raster, as the JAX loader does, and the loader says so once."""
    from complex_yolov4_tpu import native

    monkeypatch.setattr(native, "is_available", lambda: False)

    def scale(rng, img, targets_mask):
        return img * np.float32(0.5), targets_mask

    ds = TDataset(root, mode="train", aug_transforms=scale)
    loader = tloader.BatchIterator(ds, 2, shuffle=False, drop_last=True, device_raster=True,
                                   prefetch=0)
    with pytest.warns(UserWarning, match="rastered on the host") as record:
        batches = list(loader)
    assert len(batches) == 3 and all("image" in b and "points" not in b for b in batches)
    assert sum("rastered on the host" in str(w.message) for w in record) == 1
    img, targets, mask = ds.load_sample(0, np.random.default_rng(0))[1:]
    assert batches[0]["image"].shape[1:] == img.shape
