"""Port rotated IoU and NMS vs the JAX package, in f32.

Rotated IoU: 256 random box pairs against the JAX kernel, plus the
analytic cases of tests/test_rotated_boxes.py. NMS: the same decoded
arrays through both `nms_batch`s. The arrays are f32 and tie-free on
purpose: top-k order among equal scores is undefined (nms.py:57-58), and
bf16 features would make ties likely. Keep masks must be equal and merged
rows within 1e-3 px (the weighted merge is true f32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.ops import nms as jnms
from complex_yolov4_tpu.ops import rotated_boxes as jrb
from complex_yolov4_tpu_torch.ops import nms as tnms
from complex_yolov4_tpu_torch.ops import rotated_boxes as trb
from tests._torch_port_util import capped_threads  # noqa: F401


def _rand_boxes(rng, n, center=10.0, spread=6.0):
    return np.stack([
        rng.uniform(center - spread, center + spread, n),
        rng.uniform(center - spread, center + spread, n),
        rng.uniform(1.0, 8.0, n),
        rng.uniform(1.0, 8.0, n),
        rng.uniform(-2 * np.pi, 2 * np.pi, n),
    ], axis=-1).astype(np.float32)


def test_box_corners_match():
    b = _rand_boxes(np.random.default_rng(1), 16)
    np.testing.assert_allclose(trb.box_corners(torch.from_numpy(b)).numpy(),
                               np.asarray(jrb.box_corners(jnp.asarray(b))),
                               rtol=1e-6, atol=1e-5)


def test_rotated_iou_random_pairs():
    rng = np.random.default_rng(7)
    b1, b2 = _rand_boxes(rng, 256), _rand_boxes(rng, 256)
    ref = np.asarray(jrb.rotated_iou(jnp.asarray(b1), jnp.asarray(b2)))
    got = trb.rotated_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert (ref > 0.05).sum() > 30  # many real overlaps, not just zeros
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _iou(a, b):
    return float(trb.rotated_iou(torch.tensor([a]), torch.tensor([b]))[0])


def _inter(a, b):
    return float(trb.intersection_area(torch.tensor([a]), torch.tensor([b]))[0])


def test_rotated_iou_analytic():
    assert _iou([5.0, 5.0, 2.0, 4.0, 0.3], [5.0, 5.0, 2.0, 4.0, 0.3]) == pytest.approx(1.0, abs=1e-5)
    assert _iou([0.0, 0.0, 2.0, 2.0, 0.5], [100.0, 100.0, 2.0, 2.0, 1.0]) == pytest.approx(0.0, abs=1e-6)
    # 4x4 vs the same shifted by (2, 0): inter 8, union 24
    assert _iou([0.0, 0.0, 4.0, 4.0, 0.0], [2.0, 0.0, 4.0, 4.0, 0.0]) == pytest.approx(8 / 24, abs=1e-5)
    # unit square vs itself rotated 45 deg: octagon 2(sqrt2 - 1)
    assert _inter([0.0, 0.0, 1.0, 1.0, 0.0], [0.0, 0.0, 1.0, 1.0, np.pi / 4]) == pytest.approx(
        2 * (np.sqrt(2) - 1), abs=1e-5)
    # contained box
    assert _inter([0.0, 0.0, 10.0, 10.0, 0.2], [0.0, 0.0, 2.0, 3.0, 1.1]) == pytest.approx(6.0, abs=1e-4)
    assert _iou([0.0, 0.0, 10.0, 10.0, 0.2], [0.0, 0.0, 2.0, 3.0, 1.1]) == pytest.approx(0.06, abs=1e-5)


def _decoded(seed, b=2, n=600):
    """Tie-free f32 decoded rows with clusters of overlapping boxes."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 580, (b, 40, 2))
    pick = rng.integers(0, 40, (b, n))
    xy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 4, (b, n, 2))
    wl = rng.uniform(8, 40, (b, n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (b, n)) * 0.2 + (pick % 3)[...] * 0.5
    conf = rng.uniform(0.2, 1.0, (b, n))
    cls = rng.uniform(0.0, 1.0, (b, n, 3))
    d = np.concatenate([xy, wl, np.sin(yaw)[..., None], np.cos(yaw)[..., None],
                        conf[..., None], cls], axis=-1).astype(np.float32)
    score = d[..., 6] * d[..., 7:].max(-1)
    assert all(len(np.unique(s)) == n for s in score)  # tie-free
    return d


@pytest.mark.parametrize("seed,conf,nms,k", [(0, 0.5, 0.5, 64), (1, 0.3, 0.2, 256),
                                             (2, 0.5, 0.4, 128)])
def test_nms_batch_matches_jax(seed, conf, nms, k):
    d = _decoded(seed)
    jd, jm = jnms.nms_batch(jnp.asarray(d), conf, nms, k)
    td, tm = tnms.nms_batch(torch.from_numpy(d), conf, nms, k)
    jd, jm = np.asarray(jd), np.asarray(jm)
    assert td.shape == jd.shape and tm.shape == jm.shape
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert jm.sum(1).min() > 5 and (jm.sum(1) < np.minimum(k, 600)).all()  # NMS suppressed some
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-3, rtol=0)
