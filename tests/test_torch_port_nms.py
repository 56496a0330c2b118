"""Port rotated IoU and NMS vs the JAX package, in f32.

Rotated IoU: 256 random box pairs against the JAX kernel, plus the
analytic cases of tests/test_rotated_boxes.py. NMS: the same decoded
arrays through both `nms_batch`s. The arrays are f32 and tie-free on
purpose: top-k order among equal scores is undefined (nms.py:57-58), and
bf16 features would make ties likely. Keep masks must be equal and merged
rows within 1e-3 px (the weighted merge is true f32 on both sides).

The CUDA kernel (`csrc/nms.cu`) runs only on the card
(`tests/test_torch_port_gpu.py` holds it to `nms_batch_plain` there); here
a NumPy model of its algorithm (top-k by score and lower row, a greedy
pass over the suppression bits, the absorber merge summed in rank order)
is held to `nms_batch_plain`, and a CPU tensor is shown to take the plain
path.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.ops import nms as jnms
from complex_yolov4_tpu.ops import rotated_boxes as jrb
from complex_yolov4_tpu_torch.ops import nms as tnms
from complex_yolov4_tpu_torch.ops import rotated_boxes as trb
from complex_yolov4_tpu_torch.utils import tracing
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


# The CUDA kernel's algorithm (csrc/nms.cu), modelled in NumPy: candidates
# by (score, lower row), the same-class suppression bits from the plain
# IoU of each pair i < j (i's box first), one sequential greedy pass over
# the bits, each candidate absorbed by the lowest-ranked keeper suppressing
# it, and each keeper's conf-weighted mean summed in rank order in f32. It
# must keep what `nms_batch_plain`'s fixpoint rounds keep, and merge the
# same rows up to the order of the f32 sums.

def _kernel_model(d, conf_thresh, nms_thresh, max_boxes):
    b, n, _ = d.shape
    k = min(max_boxes, n)
    out = np.zeros((b, max_boxes, 9), np.float32)
    mask = np.zeros((b, max_boxes), np.float32)
    thr = np.float32(nms_thresh)
    for f in range(b):
        conf, cls = d[f, :, 6], d[f, :, 7:]
        cls_conf, cls_id = cls.max(-1), cls.argmax(-1)
        score = conf * cls_conf
        rows = np.flatnonzero(conf >= np.float32(conf_thresh))
        rows = rows[np.lexsort((rows, -score[rows]))][:k]
        nv = len(rows)
        cand = np.concatenate([d[f, rows, :7], cls_conf[rows, None],
                               cls_id[rows, None].astype(np.float32)], axis=1)
        bits = np.zeros((nv, nv), bool)
        if nv > 1:
            t = torch.from_numpy(cand)
            b5 = torch.stack([t[:, 0], t[:, 1], t[:, 2], t[:, 3], torch.atan2(t[:, 4], t[:, 5])], -1)
            ii, jj = np.triu_indices(nv, 1)
            iou = trb.rotated_iou(b5[ii], b5[jj]).numpy()
            hit = (iou > thr) & (cand[ii, 8] == cand[jj, 8])
            bits[ii[hit], jj[hit]] = bits[jj[hit], ii[hit]] = True
        kept = np.zeros(nv, bool)
        for i in range(nv):  # the greedy pass: one bit row a candidate
            kept[i] = not (bits[i, :i] & kept[:i]).any()
        if nv == 0:
            continue
        sup = bits | (np.eye(nv, dtype=bool) if np.float32(1.0) > thr else False)
        by_keeper = sup & kept[:, None]  # [i, j]: keeper i suppresses j
        absorber = np.where(by_keeper.any(0), by_keeper.argmax(0), -1)
        for i in np.flatnonzero(kept):
            group = np.flatnonzero(absorber == i)
            w = cand[group, 6]
            wsum = np.cumsum(w, dtype=np.float32)[-1] if len(group) else np.float32(0)
            acc = (np.cumsum(w[:, None] * cand[group, :6], axis=0, dtype=np.float32)[-1]
                   if len(group) else np.zeros(6, np.float32))
            out[f, i, :6] = acc / max(wsum, np.float32(1e-16))
            out[f, i, 6:] = cand[i, 6:]
            mask[f, i] = 1.0
    return out, mask


def _crowd(seed, n=300):
    """One frame of near-copies of one box: the best suppresses all the rest."""
    rng = np.random.default_rng(seed)
    yaw = 0.3 + rng.normal(0, 0.01, n)
    d = np.stack([300 + rng.normal(0, 0.5, n), 200 + rng.normal(0, 0.5, n),
                  20 + rng.normal(0, 0.3, n), 40 + rng.normal(0, 0.3, n), np.sin(yaw),
                  np.cos(yaw), rng.uniform(0.6, 1.0, n), rng.uniform(0.5, 1.0, n)], -1)
    return d[None].astype(np.float32)


def _model_case(name):
    if name.startswith("seed"):
        return _decoded(int(name[4:])), 0.5, 0.4, 128
    if name == "low_thresholds":
        return _decoded(3), 0.3, 0.2, 256
    if name == "chain":  # each box suppresses the next: half the rounds of the chain
        rows = [[3.0 * i, 0.0, 10.0, 10.0, 0.0, 1.0, 0.9 - 0.01 * i, 1.0] for i in range(30)]
        return np.array([rows], np.float32), 0.5, 0.5, 64
    if name == "crowd":
        return _crowd(0), 0.5, 0.5, 64
    if name == "mixed_classes":  # 6 classes: suppression only within a class
        d = _decoded(4, n=400)
        cls = np.random.default_rng(4).uniform(0.0, 1.0, (2, 400, 6)).astype(np.float32)
        return np.concatenate([d[..., :7], cls], -1), 0.3, 0.3, 128
    if name == "no_candidate":
        d = _decoded(5)
        d[1, :, 6] *= 0.1  # frame 1: every conf below the threshold
        return d, 0.5, 0.5, 64
    if name == "thresh_one":  # IoU 1.0 does not exceed it: no group holds its keeper
        return _decoded(6), 0.5, 1.0, 64
    raise KeyError(name)


@pytest.mark.parametrize("name", ["seed0", "seed1", "seed2", "low_thresholds", "chain", "crowd",
                                  "mixed_classes", "no_candidate", "thresh_one"])
def test_kernel_model_matches_plain(name):
    d, conf, nms, k = _model_case(name)
    want_rows, want_mask = tnms.nms_batch_plain(torch.from_numpy(d), conf, nms, k)
    got_rows, got_mask = _kernel_model(d, conf, nms, k)
    np.testing.assert_array_equal(got_mask, want_mask.numpy())
    np.testing.assert_allclose(got_rows, want_rows.numpy(), rtol=1e-5, atol=1e-6)
    kept = want_mask.numpy().sum(1)
    if name == "chain":
        assert kept.tolist() == [15]
    elif name == "crowd":
        assert kept.tolist() == [1]
    elif name == "no_candidate":
        assert kept[1] == 0 and kept[0] > 0
    elif name != "thresh_one":
        assert (kept < np.minimum(k, d.shape[1])).all()  # something was suppressed


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the kernel's wrapper: it runs the plain
    loop, which counts `nms.rounds`, and counts no `nms.kernel` and no
    launch."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel wrapper ran on a CPU tensor")

    monkeypatch.setattr(tnms, "_nms_kernel", refuse)
    launches = tnms.nms_batch.launches
    with tracing.recording() as rec:
        with tracing.span("serve"):
            rows, mask = tnms.nms_batch(torch.from_numpy(_decoded(0)), 0.5, 0.5, 64)
    assert tnms.nms_batch.launches == launches
    assert rec.counters[0].get("nms.rounds", 0) >= 1 and "nms.kernel" not in rec.counters[0]
    want = tnms.nms_batch_plain(torch.from_numpy(_decoded(0)), 0.5, 0.5, 64)
    assert torch.equal(rows, want[0]) and torch.equal(mask, want[1])


@pytest.mark.parametrize("n,max_boxes", [(300, 257), (600, 300)])
def test_kernel_wrapper_refuses_k_over_max(n, max_boxes, monkeypatch):
    """k = min(max_boxes, N) above the library's limit raises before the
    kernel is called (a stand-in library states csrc/nms.cu's limits and
    refuses any call)."""
    def refuse(*args):
        raise AssertionError("the kernel ran with k over the limit")

    lib = types.SimpleNamespace(nms_limits=(256, 2048, 16384), cyv4_nms=refuse)
    monkeypatch.setattr(tnms._build, "load", lambda: lib)
    with pytest.raises(ValueError, match="at most 256 candidates"):
        tnms._nms_kernel(torch.zeros((1, n, 10)), 0.5, 0.5, max_boxes)
