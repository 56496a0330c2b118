"""The port's eval metrics vs the JAX package's.

`ops.rotated_boxes.pairwise_rotated_iou` against the JAX original (random
and analytic boxes), and `sample_statistics`, `ap_per_class`,
`compute_ap` and `summarize_map` equal to the JAX package's on the
constructed cases of tests/test_nms_eval.py, with the detections given as
numpy and as tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.evaluation import metrics as JM
from complex_yolov4_tpu.ops import rotated_boxes as jrb
from complex_yolov4_tpu_torch.evaluation import metrics as TM
from complex_yolov4_tpu_torch.ops import rotated_boxes as trb
from tests._torch_port_util import capped_threads  # noqa: F401

IOU_TOL = 1e-5  # f32 geometry: two orders of summation of the same shoelace


def _boxes(rng, n):
    return np.stack([rng.uniform(0, 60, n), rng.uniform(0, 60, n), rng.uniform(2, 20, n),
                     rng.uniform(2, 40, n), rng.uniform(-np.pi, np.pi, n)],
                    axis=-1).astype(np.float32)


def test_pairwise_rotated_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 37), _boxes(rng, 11)
    b[:3] = a[:3]  # identical pairs
    ref = np.asarray(jrb.pairwise_rotated_iou(jnp.asarray(a), jnp.asarray(b)))
    got = trb.pairwise_rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == ref.shape == (37, 11)
    assert (ref > 0.05).sum() > 20  # overlaps, not only empty pairs
    np.testing.assert_allclose(got, ref, atol=IOU_TOL)
    np.testing.assert_allclose(np.diag(got[:3, :3]), 1.0, atol=IOU_TOL)


def test_pairwise_rotated_iou_analytic():
    sq = np.array([[0, 0, 2, 2, 0]], np.float32)
    others = np.array([[0, 0, 2, 2, np.pi / 2],   # the same square turned: 1
                       [1, 0, 2, 2, 0],           # half overlap: 2 / 6
                       [5, 5, 2, 2, 0.3],         # disjoint: 0
                       [0, 0, 2, 2, np.pi / 4]],  # octagon 8(sqrt2-1) over 8-that
                      np.float32)
    got = trb.pairwise_rotated_iou(torch.from_numpy(sq), torch.from_numpy(others)).numpy()[0]
    octagon = 8 * (np.sqrt(2) - 1)
    np.testing.assert_allclose(got, [1.0, 2 / 6, 0.0, octagon / (8 - octagon)], atol=1e-5)


def test_compute_ap_known_curve():
    recall = np.array([0.5, 0.5, 1.0])
    precision = np.array([1.0, 0.5, 2 / 3])
    got = TM.compute_ap(recall, precision)
    assert got == JM.compute_ap(recall, precision)
    assert got == pytest.approx(0.5 * 1.0 + 0.5 * (2 / 3), abs=1e-9)


@pytest.mark.parametrize("target_cls", [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 2.0]])
def test_ap_per_class_equal(target_cls):
    tp = np.array([1.0, 1.0, 1.0])
    conf = np.array([0.9, 0.8, 0.7])
    pred_cls = np.array([0.0, 0.0, 1.0])
    for a, b in zip(JM.ap_per_class(tp, conf, pred_cls, np.array(target_cls)),
                    TM.ap_per_class(tp, conf, pred_cls, np.array(target_cls))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_sample_statistics_matching(as_tensor):
    img_size = 608.0
    targets = np.zeros((4, 7), np.float32)
    tmask = np.zeros((4,), np.float32)
    targets[0] = [0, 0.5, 0.5, 0.05, 0.1, 0.0, 1.0]
    targets[1] = [1, 0.2, 0.2, 0.03, 0.05, 0.0, 1.0]
    tmask[:2] = 1
    # det 0 matches target 0; det 1 wrong class; det 2 duplicate of target 0
    dets = np.zeros((3, 9), np.float32)
    dmask = np.ones((3,), np.float32)
    dets[0] = [0.5 * 608, 0.5 * 608, 0.05 * 608, 0.1 * 608, 0, 1, 0.9, 0.9, 0]
    dets[1] = [0.2 * 608, 0.2 * 608, 0.03 * 608, 0.05 * 608, 0, 1, 0.8, 0.8, 2]
    dets[2] = [0.5 * 608 + 2, 0.5 * 608, 0.05 * 608, 0.1 * 608, 0, 1, 0.7, 0.7, 0]
    ref = JM.sample_statistics(dets, dmask, targets, tmask, 0.5, img_size)
    if as_tensor:
        dets, dmask = torch.from_numpy(dets), torch.from_numpy(dmask)
    got = TM.sample_statistics(dets, dmask, targets, tmask, 0.5, img_size)
    np.testing.assert_allclose(got[0], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(got[2], [0, 2, 0])
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _oracle_case(rng, n_frames=4):
    """Detections copied from the ground truth (4 rows, the dead ones
    masked, so that the JAX IoU compiles once), and the targets."""
    cases = []
    for _ in range(n_frames):
        targets = np.zeros((8, 7), np.float32)
        tmask = np.zeros((8,), np.float32)
        n = int(rng.integers(1, 5))
        for t in range(n):
            yaw = rng.uniform(-np.pi, np.pi)
            targets[t] = [rng.integers(0, 3), rng.uniform(0.2, 0.8),
                          rng.uniform(0.2, 0.8), 0.05, 0.1, np.sin(yaw), np.cos(yaw)]
            tmask[t] = 1
        dets = np.zeros((4, 9), np.float32)
        for t in range(n):
            dets[t, :6] = [targets[t, 1] * 608, targets[t, 2] * 608,
                           targets[t, 3] * 608, targets[t, 4] * 608,
                           targets[t, 5], targets[t, 6]]
            dets[t, 6:] = [0.95, 0.95, targets[t, 0]]
        cases.append((dets, (np.arange(4) < n).astype(np.float32), targets, tmask))
    return cases


def test_summarize_map_oracle_equal():
    """Oracle detections -> mAP 1 in both packages, every output equal; and
    a perturbed run (one frame's detections shifted off) equal too."""
    cases = _oracle_case(np.random.default_rng(7))
    for shift in (0.0, 40.0):
        outs = []
        for M in (JM, TM):
            stats, labels = [], []
            for k, (dets, dmask, targets, tmask) in enumerate(cases):
                d = dets.copy()
                if k == 1:
                    d[:, 0] += shift
                stats.append(M.sample_statistics(d, dmask, targets, tmask, 0.5, 608.0))
                labels.append(targets[tmask > 0.5][:, 0])
            outs.append(M.summarize_map(stats, labels))
        jo, to = outs
        assert set(jo) == set(to)
        for k in jo:
            np.testing.assert_array_equal(np.asarray(jo[k]), np.asarray(to[k]), err_msg=k)
        if shift == 0.0:
            assert to["mAP"] == pytest.approx(1.0)
        else:
            assert to["mAP"] < 1.0
