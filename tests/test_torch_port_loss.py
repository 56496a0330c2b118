"""The port's training math vs the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages:

- `conv3x3_plain` on an f32 x (the f32 contract of the 3x3 kernel) against
  the Pallas `conv3x3_fused` on the same f32 x in interpret mode: both
  round x and w to bf16, sum in f32 and keep the f32 output; held to 1e-5
  of max |ref| (summation order only);
- `rotated_giou`, `_hull_area_xy` and `_hull_area_8`: values within 1e-5
  (abs, on unit-scale boxes) and gradients within 1e-4 of the JAX ones
  (the GIoU gradients on generic pairs: identical boxes are a kink);
- `network_loss` in MSE and GIoU modes on random head outputs of
  complex_yolov4_tiny: the total and all 18 metrics of each head within
  rtol 1e-5, the gradients w.r.t. the raw head outputs within 1e-5 of
  their max |.|; `want_metrics=False` zeroes the 8 metric-only entries;
- the duplicate-target winner (the later target wins) and the saturated
  BCE gradient (finite, bounded), as tests/test_loss.py checks the JAX
  package;
- `bn_train` (bf16 residual BN): outputs, batch statistics and gradients
  against the JAX custom VJP on the same bf16 input (f32 stats within
  1e-5, bf16 outputs and input gradient within one bf16 step, scale and
  bias gradients within 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from complex_yolov4_tpu.losses import yolo_loss as jloss
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import bn_train as jbn
from complex_yolov4_tpu.models.yolo_head import decode_head
from complex_yolov4_tpu.ops import pallas_conv
from complex_yolov4_tpu.ops import rotated_boxes as jrb
from complex_yolov4_tpu_torch.losses import yolo_loss as tloss
from complex_yolov4_tpu_torch.models import bn_train as tbn
from complex_yolov4_tpu_torch.models import zoo
from complex_yolov4_tpu_torch.models.yolo_head import decode_head_raw
from complex_yolov4_tpu_torch.ops import conv3x3 as tconv
from complex_yolov4_tpu_torch.ops import rotated_boxes as trb

NAME = "complex_yolov4_tiny"


@pytest.mark.parametrize("stride,act", [(1, "mish"), (2, "leaky")])
def test_conv3x3_plain_f32_matches_pallas(monkeypatch, stride, act):
    rng = np.random.default_rng(stride)
    x = rng.normal(0, 1, (1, 16, 256, 32)).astype(np.float32)
    w = rng.normal(0, 0.05, (3, 3, 32, 64)).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    monkeypatch.setattr(pallas_conv, "ENABLED", True)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_conv.conv3x3_fused(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), stride=stride,
            activation=act, interpret=True))
    assert ref.dtype == np.float32
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tconv.conv3x3_fused(torch.from_numpy(x), tconv.pack_weight(w_oihw),
                              torch.from_numpy(bias), stride=stride, activation=act)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _boxes(rng, n):
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0.3, 2.0, n),
                     rng.uniform(0.3, 2.0, n), rng.uniform(-np.pi, np.pi, n)], -1
                    ).astype(np.float32)


def test_rotated_giou_values_and_grads():
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 64), _boxes(rng, 64)
    b2[:8] = b1[:8]  # identical pairs: GIoU 1
    b2[8:16, :2] += 10.0  # disjoint pairs: GIoU < 0
    jg, ji = jax.jit(jrb.rotated_giou)(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    tg, ti = trb.rotated_giou(t1, t2)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), atol=1e-5)
    assert (tg[8:16] < 0).all() and torch.allclose(tg[:8], torch.ones(8), atol=1e-5)

    # gradients on the generic pairs: identical boxes are a kink of the
    # intersection area (coincident corners), where any subgradient is right
    b1, b2 = b1[8:], b2[8:]

    def jloss_fn(a, b):
        g, i = jrb.rotated_giou(a, b)
        return jnp.sum(g * jnp.arange(56.0) / 56.0) + jnp.sum(i)
    ga, gb = jax.jit(jax.grad(jloss_fn, argnums=(0, 1)))(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    tg, ti = trb.rotated_giou(t1, t2)
    (tg * torch.arange(56.0) / 56.0).sum().add(ti.sum()).backward()
    for got, ref in ((t1.grad, ga), (t2.grad, gb)):
        ref = np.asarray(ref)
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)


def test_hull_area_values_and_grads():
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 1, (8, 2, 16)).astype(np.float32)
    pts[:, :, 0] = 0.0           # all points coincide: area 0
    pts[:4, :, 1] = pts[4:, :, 1]  # duplicates
    pts[:, 1, 2] = pts[:, 0, 2]  # collinear on y = x
    jarea = jax.jit(jrb._hull_area_xy)(jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    px = torch.from_numpy(pts[:, 0].copy()).requires_grad_()
    py = torch.from_numpy(pts[:, 1].copy()).requires_grad_()
    tarea = trb._hull_area_xy(px, py)
    np.testing.assert_allclose(tarea.detach().numpy(), np.asarray(jarea), atol=1e-5)
    assert float(tarea[0].detach()) == 0.0 and abs(float(tarea[2].detach())) < 1e-5
    gx, gy = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jrb._hull_area_xy(a, b) * jnp.arange(16.0)),
        argnums=(0, 1)))(jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    (tarea * torch.arange(16.0)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(py.grad.numpy(), np.asarray(gy), atol=1e-4)
    one = pts[:, :, 5]
    assert float(trb._hull_area_8(torch.from_numpy(one))) == pytest.approx(
        float(jrb._hull_area_8(jnp.asarray(one))), abs=1e-5)


def _targets(rng, b_sz, t_cap=12, n_live=7, nc=3):
    targets = np.zeros((b_sz, t_cap, 7), np.float32)
    mask = np.zeros((b_sz, t_cap), np.float32)
    for b in range(b_sz):
        for t in range(n_live):
            yaw = rng.uniform(-np.pi, np.pi)
            targets[b, t] = [rng.integers(0, nc), rng.uniform(0.05, 0.95),
                             rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.3),
                             rng.uniform(0.05, 0.5), np.sin(yaw), np.cos(yaw)]
            mask[b, t] = 1
    targets[0, n_live] = targets[0, 0]  # a duplicate: same cell, same anchor
    targets[0, n_live, 0] = (targets[0, 0, 0] + 1) % nc
    mask[0, n_live] = 1
    return targets, mask


@pytest.mark.parametrize("giou", [False, True], ids=["mse", "giou"])
def test_network_loss_matches_jax(giou):
    size = 128
    jspec = get_model_spec(NAME, width=size, height=size)
    tspec = zoo.get_model_spec(NAME, width=size, height=size)
    rng = np.random.default_rng(3)
    feats = []
    for i in tspec.yolo_indices:
        layer = tspec.layers[i]
        g = size // (32 if len(feats) == 0 else 16)
        feats.append(rng.normal(0, 1.5, (2, g, g, layer.num_anchors * (7 + layer.num_classes)))
                     .astype(np.float32))
    targets, mask = _targets(rng, 2)

    def jfn(fs):
        raws = [decode_head(f, jspec.layers[i], size) for f, i in zip(fs, jspec.yolo_indices)]
        return jloss.network_loss(jspec, raws, jnp.asarray(targets), jnp.asarray(mask),
                                  use_giou_loss=giou)

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    raws = [decode_head_raw(f, tspec.layers[i], size) for f, i in zip(tfeats, tspec.yolo_indices)]
    total, metrics = tloss.network_loss(tspec, raws, torch.from_numpy(targets),
                                        torch.from_numpy(mask), use_giou_loss=giou)
    total.backward()
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    for tm, jm in zip(metrics, jmetrics):
        assert tm.keys() == jm.keys() and len(tm) == 18
        for k in tm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), k
    for tf, jg in zip(tfeats, jgrads):
        got = tf.grad.permute(0, 2, 3, 1).numpy()
        ref = np.asarray(jg)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    _, lean = tloss.network_loss(tspec, raws, torch.from_numpy(targets), torch.from_numpy(mask),
                                 use_giou_loss=giou, want_metrics=False)
    for k in ("iou_score", "cls_acc", "recall50", "precision", "conf_obj"):
        assert float(lean[0][k]) == 0.0
    assert float(lean[0]["loss"]) == pytest.approx(float(metrics[0]["loss"]), rel=1e-6)


def test_last_target_wins_on_duplicate_cell():
    g, nc = 8, 3
    anchors = np.array([[1.0, 2.0, 0.0, 1.0], [2.0, 2.0, 0.0, 1.0], [3.0, 5.0, 0.0, 1.0]],
                       np.float32)
    targets = np.zeros((1, 4, 7), np.float32)
    mask = np.zeros((1, 4), np.float32)
    targets[0, 0] = [0, 4.2 / g, 4.3 / g, 0.25, 0.25, 0.0, 1.0]
    targets[0, 1] = [1, 4.7 / g, 4.6 / g, 0.25, 0.25, 0.0, 1.0]
    mask[0, :2] = 1
    dense = tloss.build_targets_dense(g, torch.from_numpy(anchors), nc,
                                      torch.from_numpy(targets), torch.from_numpy(mask), 0.7)
    jdense = jax.jit(lambda a, t, m: jloss.build_targets_dense(g, a, nc, t, m, 0.7))(
        jnp.asarray(anchors), jnp.asarray(targets), jnp.asarray(mask))
    assert float(dense["obj"].sum()) == 1.0
    nz = int(torch.argmax(dense["obj"]))
    assert float(dense["tx"][nz]) == pytest.approx(0.7, abs=1e-6)
    assert float(dense["ty"][nz]) == pytest.approx(0.6, abs=1e-6)
    np.testing.assert_allclose(dense["tcls"][nz].numpy(), [0, 1, 0])
    assert not bool(dense["is_winner"][0, 0]) and bool(dense["is_winner"][0, 1])
    for k in ("obj", "noobj", "tx", "ty", "tw", "th", "tim", "tre", "tcls"):
        np.testing.assert_allclose(dense[k].numpy(), np.asarray(jdense[k]), atol=1e-6)


def test_bce_saturated_gradients_finite():
    p = torch.tensor([0.0, 1.0, 0.5, 1e-20, 1.0 - 1e-7], requires_grad=True)
    t = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    val = tloss.bce(p, t)
    assert torch.isfinite(val).all()
    val.sum().backward()
    assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) <= 1.1e12
    jval = jloss._bce(jnp.asarray(p.detach().numpy()), jnp.asarray(t.numpy()))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), rtol=1e-6)
    mid = torch.tensor(0.5, requires_grad=True)
    tloss.bce(mid, torch.tensor(1.0)).backward()
    assert float(mid.grad) == pytest.approx(-2.0, rel=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (3, 8, 5, 7)])
def test_bn_train_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    b, c, h, w = shape
    x = rng.normal(0.5, 2.0, (b, h, w, c)).astype(np.float32)
    x_bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    gy = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)

    def jfn(xx, s, bb):
        y, mean, var = jbn.bn_train(xx, s, bb)
        return jnp.sum(y.astype(jnp.float32) * gy), (y, mean, var)

    (_, (jy, jmean, jvar)), (jgx, jgs, jgb) = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x_bf).astype(jnp.bfloat16),
                                               jnp.asarray(scale), jnp.asarray(bias))
    tx = torch.from_numpy(x_bf.copy()).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y, mean, var = tbn.bn_train(tx, ts, tb)
    assert y.dtype == torch.bfloat16 and not mean.requires_grad
    (y.float() * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5)
    ulp = 2.0 ** -7 * np.abs(np.asarray(jy, np.float32)).max()
    assert np.abs(y.detach().float().permute(0, 2, 3, 1).numpy() - np.asarray(jy, np.float32)).max() <= ulp
    ref_gx = np.asarray(jgx, np.float32)
    assert (np.abs(tx.grad.float().permute(0, 2, 3, 1).numpy() - ref_gx).max()
            <= 2.0 ** -7 * np.abs(ref_gx).max())
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-4, atol=1e-4)
