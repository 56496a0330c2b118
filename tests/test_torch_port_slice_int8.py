"""The port's int8 + fused-stage serving slice vs the JAX package's.

complex_yolov4 at 128 (fused stages planned with `_MIN_W` lowered to 32 in
both packages, as tests/test_fused_stage.py does: segments 2-10 at 64 and
12-23 at 32), bf16, batch 2, int8 on the 68 convs of `default_skip`. Both
packages get the same BN-folded weights and the same JAX quant tree
(`quantize.make_quant` of the JAX package, bridged by
`weights.from_jax_quant`); calibrating twice would give s_x that differ in
the last bits and so other int8 inputs. JAX runs `network.apply` with
`use_fused_stage=True` (Pallas in interpret mode, packed2 layout) and its
int8 branch; the port runs `Darknet(quant=..., fused_stages=True)` with the
kernels' plain versions (CPU tensors).

- Decoded heads: within tests/test_fused_stage.py:127-129's limits, 3 px
  on columns 0-3 and 0.05 on columns 4+ (bf16 epilogues round at other
  places, packed2 sums in another order, and a flipped bf16 value can move
  an int8 input by one step).
- Served detections (decode + rotated NMS, k=64, nms 0.5) matched as sets.
  The port serves COO cells at the native 608 only, so both packages'
  `nms_batch` run on their own decoded heads of the same 128 raster. The
  threshold sits in a gap of the sorted JAX confidences four times wider
  than the largest confidence difference between the two packages, with
  fewer than k candidates per frame, so top-k ties cannot decide what is
  kept (PR 1's gap method). Random weights put every confidence within
  0.02 of 0.5 on bf16 levels ~6e-5 apart, where no such gap exists; the
  head convs' weights are scaled tenfold to spread the tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu.models import quantize as jqz
from complex_yolov4_tpu.ops import fused_stage as jfs
from complex_yolov4_tpu.ops.nms import nms_batch as jax_nms
from complex_yolov4_tpu_torch.models import quantize as tqz
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.ops import fused_stage as tfs
from complex_yolov4_tpu_torch.ops.nms import nms_batch
from tests._torch_port_util import capped_threads  # noqa: F401

S = 128
K = 64
HEAD_SCALE = 10.0


def _gap_threshold(conf, k, min_gap):
    """The threshold in a >= min_gap gap of the sorted confidences that
    keeps the most candidates, with 1 to k-1 of them in every frame."""
    s = np.sort(conf.ravel())[::-1]
    best = None
    for i in range(len(s) - 1):
        t = 0.5 * (s[i] + s[i + 1])
        counts = (conf >= t).sum(axis=1)
        if counts.max() >= k:
            break
        if s[i] - s[i + 1] >= min_gap and counts.min() >= 1:
            best = float(t)
    assert best is not None, "no usable confidence gap"
    return best


def test_int8_fused_slice_matches_jax(monkeypatch):
    monkeypatch.setattr(jfs, "_MIN_W", 32)
    monkeypatch.setattr(tfs, "_MIN_W", 32)
    spec = zoo.get_model_spec("complex_yolov4", width=S, height=S)
    params, state = weights.init_params_np(spec, 1)
    for i in tqz.head_conv_indices(spec):
        params[f"layer{i}"]["w"] = params[f"layer{i}"]["w"] * HEAD_SCALE
    jspec = get_model_spec("complex_yolov4", width=S, height=S)
    fparams = jnet.fold_batchnorm(jspec, params, state)
    folded = {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])} for k, v in fparams.items()}
    x = np.random.default_rng(3).uniform(0, 1, (2, S, S, 3)).astype(np.float32)

    act_max = tqz.calibrate(spec, folded, [x], device=torch.device("cpu"))
    jquant = jqz.make_quant(jspec, fparams, act_max)
    quant_np = {k: {f: np.asarray(v) for f, v in e.items()} for k, e in jquant.items()}
    assert len(quant_np) == 68

    want, _ = jax.jit(lambda p, q, xx: jnet.apply(
        jnet.fold_spec(jspec), p, {}, xx, compute_dtype=jnp.bfloat16, use_pallas_conv=False,
        stem_pallas=False, use_fused_stage=True, quant=q, batch_pack=None))(
            fparams, jquant, jnp.asarray(x))
    want = np.asarray(want)

    model = Darknet(spec, weights.from_folded(spec, folded), compute_dtype=torch.bfloat16,
                    device=torch.device("cpu"), quant=weights.from_jax_quant(spec, quant_np),
                    fused_stages=True)
    routes = model.routes(S)
    assert sum(r == "int8" for r in routes.values()) == 68
    assert {r for r in routes.values() if r.startswith("fused")} == {
        "fused_stage 2-10", "fused_stage 12-23"}
    for i, (s_x, inv) in model._quant.items():  # f32 reciprocal of the f32 s_x
        assert np.float32(inv) == np.float32(1.0) / np.float32(quant_np[f"layer{i}"]["s_x"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, spec.num_boxes(S), 10)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert float(d[..., 4:].max()) < 0.05, float(d[..., 4:].max())
    assert float(d[..., :4].max()) < 3.0, float(d[..., :4].max())

    conf_thresh = _gap_threshold(want[..., 6], K, 4 * float(d[..., 6].max()))
    jd, jm = jax_nms(jnp.asarray(want), conf_thresh, 0.5, K)
    jd, jm = np.asarray(jd), np.asarray(jm)
    td, tm = nms_batch(torch.from_numpy(got), conf_thresh, 0.5, K)
    td, tm = td.numpy(), tm.numpy()
    assert td.shape == jd.shape == (2, K, 9)
    np.testing.assert_array_equal(tm.sum(1), jm.sum(1))
    assert jm.sum() >= 2
    for b in range(2):
        j_rows, t_rows = jd[b][jm[b] > 0], td[b][tm[b] > 0]
        dist = np.abs(j_rows[:, None, :] - t_rows[None, :, :])
        close = (dist[..., :4] < 3.0).all(-1) & (dist[..., 4:] < 0.05).all(-1)
        match = np.argmax(close, axis=1)
        assert close[np.arange(len(j_rows)), match].all()
        assert len(set(match.tolist())) == len(j_rows)  # a bijection
