"""The port's native C++ rasterizer (`complex_yolov4_tpu_torch/native/`).

Built with g++ into `complex_yolov4_tpu_torch/build/`, it is held bit for
bit against the JAX package's library (built from the same source) and
against the port's numpy functions, on synthetic scenes and trees:

- `rasterize_points` against `make_bev_map(remove_points_outside(.))`;
- `aggregate_cells` against `aggregate_bev_cells(remove_points_outside(.))`;
- `rasterize_files` against per-frame rasters, and its IOError on a
  missing file;
- the fused native mosaic against the numpy mosaic canvas after the
  loader's 2:1 `resize_linear` (equal bit for bit; the JAX package holds
  its fused mosaic to cv2's resize within 1e-6), with equal targets, masks
  and RNG state, for (cutout_prob, random_padding) as tests/test_native.py;
- `resize_linear` at 2:1 against cv2.resize within 1e-6.

Skips only where no C++ compiler is on PATH; a failed build with one
present fails.
"""

import os
import shutil

import numpy as np
import pytest

from complex_yolov4_tpu import native as jnative
from complex_yolov4_tpu_torch import native
from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.data.dataset import KittiDataset
from complex_yolov4_tpu_torch.data.loader import resize_linear
from complex_yolov4_tpu_torch.data.transforms import (default_aug_transforms,
                                                      default_lidar_transforms)


@pytest.fixture(scope="module")
def lib():
    """The port's library, built here; the JAX package's, built by its own
    bindings (its Makefile, next to its source)."""
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH")
    so = native.build()  # raises on a failed build
    assert so.parent == native.BUILD_DIR and so.name.startswith("libbev_native_")
    native.load()
    assert native.is_available() and jnative.is_available()
    return so


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=6, num_val=1,
        num_test=1, seed=3)


@pytest.mark.parametrize("seed", [5, 11])
def test_rasterize_points_bit_equal(lib, seed):
    points = synthetic.sample_scene(np.random.default_rng(seed))[0]
    got = native.rasterize_points(points)
    assert got.shape == (608, 608, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, bev.make_bev_map(bev.remove_points_outside(points)))
    np.testing.assert_array_equal(got, jnative.rasterize_points(points))


@pytest.mark.parametrize("seed", [5, 11])
def test_aggregate_cells_bit_equal(lib, seed):
    points = synthetic.sample_scene(np.random.default_rng(seed), clustered=seed == 11)[0]
    cells, keys = native.aggregate_cells(points)
    c_np, k_np = bev.aggregate_bev_cells(bev.remove_points_outside(points))
    c_j, k_j = jnative.aggregate_cells(points)
    for a, b in ((cells, c_np), (keys, k_np), (cells, c_j), (keys, k_j)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_rasterize_files_bit_equal(lib, tree, tmp_path):
    paths = [os.path.join(tree, "training", "velodyne", f"{i:06d}.bin") for i in range(3)]
    batch = native.rasterize_files(paths, num_threads=2)
    assert batch.shape == (3, 608, 608, 3)
    np.testing.assert_array_equal(batch, jnative.rasterize_files(paths, num_threads=2))
    for i, p in enumerate(paths):
        pts = np.fromfile(p, np.float32).reshape(-1, 4)
        np.testing.assert_array_equal(batch[i], native.rasterize_points(pts))
        np.testing.assert_array_equal(batch[i], bev.make_bev_map(bev.remove_points_outside(pts)))
    with pytest.raises(IOError):
        native.rasterize_files([paths[0], str(tmp_path / "missing.bin")])


def _mosaic_ds(root, cutout_prob, random_padding):
    return KittiDataset(
        root, mode="train", lidar_transforms=default_lidar_transforms(True),
        aug_transforms=default_aug_transforms(0.5, cutout_prob=cutout_prob,
                                              cutout_fill_value=0.25),
        mosaic=True, random_padding=random_padding)


@pytest.mark.parametrize("cutout_prob,random_padding", [
    (0.0, True), (0.0, False), (1.0, True)])
def test_fused_mosaic_matches_numpy(lib, tree, cutout_prob, random_padding):
    """Fused C++ mosaic == numpy canvas + the loader's 2:1 resize_linear,
    from the same RNG stream (bit for bit, where the JAX package's test
    allows 1e-6 against cv2)."""
    ds = _mosaic_ds(tree, cutout_prob, random_padding)
    for seed in range(3):
        rng_n = np.random.default_rng((11, seed))
        rng_p = np.random.default_rng((11, seed))
        paths_n, fused, t_n, m_n = ds._load_mosaic_native(seed % len(ds), rng_n)
        paths_p, canvas, t_p, m_p = ds._load_mosaic_python(seed % len(ds), rng_p)
        assert paths_n == paths_p
        assert fused.shape == (608, 608, 3) and canvas.shape == (1216, 1216, 3)
        np.testing.assert_array_equal(t_n, t_p)
        np.testing.assert_array_equal(m_n, m_p)
        assert rng_n.bit_generator.state == rng_p.bit_generator.state
        ref = resize_linear(canvas, 608)
        assert np.abs(fused - ref).max() <= 1e-6
        np.testing.assert_array_equal(fused, ref)


def test_resize_linear_2to1_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1216, 1216, 3)).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.3] = 0.5  # the canvas fill value
    ref = cv2.resize(img, (608, 608), interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, 608)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
