"""The port's device points raster vs the JAX package's.

`bev.make_bev_map_points` (packed and exact modes), `make_bev_map_points_flat`
and `images_from_deferred_batch` against `make_bev_map_jax`,
`make_bev_map_jax_flat` and the JAX `images_from_deferred_batch`, and
against the host raster `make_bev_map`, on the same padded points.

Budget (the JAX package's own, tests/test_data.py:66-110): `floor(x /
disc)` may move a point that sits on a cell edge one cell over where two
implementations divide with another rounding, so fewer than 1e-4 of the
cells may differ; every other cell matches within 5e-5 (exact mode, and
port vs JAX in packed mode, whose quantization both share) or, packed
against the host, within the quantization: intensity 1/510, height 3.1e-5,
density exactly. Seeds 3, 11 and 29 hold knife-edge points.

Resize: both are half-pixel bilinear without antialiasing; JAX renormalizes
the weights of the taps that stay inside the image, PyTorch clamps the
source index, which gives the edge pixel's value in both. Measured on the
CPU on values in [0, 1): 608->416 and 608->704 (and 608->160) agree within
1.2e-7 to 1.8e-7, one or two f32 ulps of the two weight formulas; held to
RESIZE_TOL = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu_torch.data import bev, synthetic
from tests._torch_port_util import capped_threads  # noqa: F401

RESIZE_TOL = 1e-6


def _cloud(seed):
    return bev.remove_points_outside(synthetic.sample_scene(np.random.default_rng(seed))[0])


def _assert_within_budget(got, ref, tol=5e-5):
    mismatched = np.abs(got - ref).max(axis=-1) > tol
    assert mismatched.mean() < 1e-4, f"{mismatched.sum()} cells differ"
    np.testing.assert_allclose(got[~mismatched], ref[~mismatched], atol=tol)
    return mismatched


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("seed", [0, 3, 11, 29])
def test_points_raster_matches_jax(seed, packed):
    cropped = _cloud(seed)
    padded, mask = bev.pad_points(cropped, 30_000)
    ref = np.asarray(jbev.make_bev_map_jax(padded, mask, packed=packed))
    got = bev.make_bev_map_points(torch.from_numpy(padded), torch.from_numpy(mask),
                                  packed=packed).numpy()
    assert got.shape == ref.shape == (608, 608, 3) and got.dtype == np.float32
    _assert_within_budget(got, ref)

    host = bev.make_bev_map(cropped)
    if not packed:
        _assert_within_budget(got, host)
        return
    mismatched = np.abs(got - host).max(axis=-1) > 2.5e-3
    assert mismatched.mean() < 1e-4, f"{mismatched.sum()} cells differ"
    err = np.abs(got[~mismatched] - host[~mismatched]).reshape(-1, 3)
    assert err[:, 0].max() <= 1.0 / 510 + 1e-6   # intensity: 8-bit quantization
    assert err[:, 1].max() <= 3.1e-5             # height: 15-mantissa-bit truncation
    assert err[:, 2].max() == 0.0                # density: identical


def test_points_raster_batched_and_flat():
    """A (2, 2, N) batch and the flat layout (3 frames, a truncating
    capacity) give the same frames as the JAX package."""
    clouds = [_cloud(s) for s in (1, 2, 5, 7)]
    pads = [bev.pad_points(c, 24_000) for c in clouds]
    pts = np.stack([p for p, _ in pads]).reshape(2, 2, 24_000, 4)
    msk = np.stack([m for _, m in pads]).reshape(2, 2, 24_000)
    ref = np.asarray(jbev.make_bev_map_jax(pts, msk))
    got = bev.make_bev_map_points(torch.from_numpy(pts), torch.from_numpy(msk)).numpy()
    assert got.shape == ref.shape == (2, 2, 608, 608, 3)
    _assert_within_budget(got.reshape(-1, 608, 3), ref.reshape(-1, 608, 3))

    cap = sum(len(c) for c in clouds[:3]) - 500
    fp, fid, fm = bev.pack_points_flat(clouds[:3], cap)
    ref = np.asarray(jbev.make_bev_map_jax_flat(fp, fid, fm, 3))
    got = bev.make_bev_map_points_flat(torch.from_numpy(fp), torch.from_numpy(fid),
                                       torch.from_numpy(fm), 3).numpy()
    assert got.shape == ref.shape == (3, 608, 608, 3)
    _assert_within_budget(got.reshape(-1, 608, 3), ref.reshape(-1, 608, 3))


@pytest.mark.parametrize("out_size", [608, 416, 704])
def test_images_from_deferred_batch(out_size):
    """Flip, cutout holes (one masked off) and the resize, against JAX."""
    pads = [bev.pad_points(_cloud(s), 24_000) for s in (3, 8)]
    holes = np.array([[[10, 200, 300, 420, 0.5], [0, 608, 0, 608, 0.0]],
                      [[400, 608, 0, 90, 0.25], [50, 60, 50, 60, 1.0]]], np.float32)
    batch = {"points": np.stack([p for p, _ in pads]),
             "point_mask": np.stack([m for _, m in pads]),
             "flip": np.array([1.0, 0.0], np.float32),
             "holes": holes,
             "hole_mask": np.array([[1.0, 0.0], [1.0, 1.0]], np.float32)}
    ref = np.asarray(jbev.images_from_deferred_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, out_size))
    got = bev.images_from_deferred_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, out_size).numpy()
    assert got.shape == ref.shape == (2, out_size, out_size, 3)
    if out_size == 608:
        _assert_within_budget(got.reshape(-1, 608, 3), ref.reshape(-1, 608, 3))
        np.testing.assert_array_equal(got[0, 10:200, 300:420], 0.5)  # hole after the flip
        np.testing.assert_array_equal(got[1, 50:60, 50:60], 1.0)
    else:
        # a knife-edge cell spreads over the resize taps; everything else
        # matches within the resize tolerance
        bad = np.abs(got - ref).max(axis=-1) > RESIZE_TOL
        assert bad.mean() < 1e-3, f"{bad.sum()} pixels differ"


@pytest.mark.parametrize("out_size", [416, 704])
def test_resize_matches_jax(out_size):
    rng = np.random.default_rng(out_size)
    img = rng.uniform(0.0, 1.0, (2, 608, 608, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2, out_size, out_size, 3),
                                      method="linear", antialias=False))
    got = bev.resize_images(torch.from_numpy(img), out_size).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=RESIZE_TOL, rtol=0)
