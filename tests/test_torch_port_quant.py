"""The port's int8 PTQ and int8 conv vs the JAX package's.

- `chain_set`, `default_skip` and `head_conv_indices` equal JAX's for all
  four topologies; `quantize_weights` is bit-identical; `calibrate`'s
  act_max agrees within 2e-2 relative on complex_yolov4_tiny at 128 (both
  run the bf16 network, whose epilogues round at other places).
- `int8_conv_plain` (what `int8_conv` runs for a CPU tensor), on an int8
  input or a bf16 one that it quantizes, against the JAX branch's input
  quantization, `jax.lax.conv_general_dilated` int8 -> int32 plus the
  epilogue of
  `network.py:489-494`: the int32 sums exactly equal, bf16 outputs within
  1 ulp, requantized int8 within 1 (the f32 epilogue may round once
  otherwise, e.g. XLA contracting y * scale + b into an FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu.models import quantize as jqz
from complex_yolov4_tpu.models.zoo import MODEL_ZOO
from complex_yolov4_tpu_torch.models import quantize as tqz
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.ops import int8_conv as tint8


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_skip_and_chain_equal_jax(name):
    js, ts = get_model_spec(name), zoo.get_model_spec(name)
    assert tqz.default_skip(ts) == jqz.default_skip(js)
    assert tqz.head_conv_indices(ts) == jqz.head_conv_indices(js)
    assert tqz.consumers(ts) == jqz.consumers(js)
    keys = [f"layer{i}" for i in range(len(ts.layers)) if i not in tqz.default_skip(ts)]
    assert tqz.chain_set(ts, keys) == jqz.chain_set(js, keys)
    if name == "complex_yolov4":
        quantized = [i for i in range(len(ts.layers)) if f"layer{i}" in keys
                     and type(ts.layers[i]).__name__ == "ConvSpec"]
        assert len(quantized) == 68 and len(tqz.chain_set(ts, keys)) == 30


def _folded(name, size, seed=0):
    spec = zoo.get_model_spec(name, width=size, height=size)
    params, state = weights.init_params_np(spec, seed)
    jspec = get_model_spec(name, width=size, height=size)
    return spec, jspec, jnet.fold_batchnorm(jspec, params, state)


def test_quantize_weights_bit_identical():
    spec, jspec, fparams = _folded("complex_yolov4", 608)
    want = jqz.quantize_weights(jspec, fparams)
    got = tqz.quantize_weights(spec, {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
                                      for k, v in fparams.items()})
    assert sorted(got) == sorted(want) and len(got) == 68
    for k in want:
        for f in ("w_i8", "w_scale", "b"):
            a, b = np.asarray(want[k][f]), got[k][f]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_calibrate_and_make_quant_match_jax():
    spec, jspec, fparams = _folded("complex_yolov4_tiny", 128)
    folded = {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])} for k, v in fparams.items()}
    batch = np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jqz.calibrate(jnet.fold_spec(jspec), fparams, [batch])
    got = tqz.calibrate(spec, folded, [batch], device=torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-2 * want[k], k
    jq = jqz.make_quant(jspec, fparams, want)
    tq = tqz.make_quant(spec, folded, want)
    assert sorted(jq) == sorted(tq)
    for k in jq:
        assert np.asarray(jq[k]["s_x"]).dtype == tq[k]["s_x"].dtype == np.float32
        assert np.float32(jq[k]["s_x"]) == tq[k]["s_x"]


def _act_jax(x, kind):
    return jnet._act(x, kind)


@pytest.mark.parametrize("k,stride,act,src,hw", [
    pytest.param(1, 1, "mish", "int8", 8, id="1-1-mish"),
    pytest.param(3, 1, "leaky", "int8", 8, id="3-1-leaky"),
    pytest.param(3, 2, "mish", "int8", 8, id="3-2-mish"),
    pytest.param(1, 2, "linear", "int8", 8, id="1-2-linear"),
    pytest.param(1, 1, "mish", "bf16", 8, id="1-1-mish-bf16"),
    pytest.param(3, 2, "leaky", "bf16", 8, id="3-2-leaky-bf16"),
    pytest.param(3, 2, "mish", "int8", 9, id="3-2-mish-odd9")])
def test_int8_conv_plain_matches_lax(k, stride, act, src, hw):
    """A "bf16" input goes to the wrapper as it is, and the port quantizes
    it (`quantize_input`, which the kernel repeats as it loads) as the JAX
    branch does (`network.py:477-482`). An odd size at stride 2 gives
    (hw - 1) // 2 + 1 rows, as the kernel's output does."""
    rng = np.random.default_rng(10 * k + stride)
    c_in, c_out = 256, 128
    x_q = rng.integers(-127, 128, (2, hw, hw, c_in)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, k, c_in, c_out)).astype(np.int8)
    w_scale = rng.uniform(1e-4, 2e-3, c_out).astype(np.float32)
    b = rng.normal(0, 0.5, c_out).astype(np.float32)
    s_x = np.float32(0.011)
    s_next = np.float32(0.037)
    pad = (k - 1) // 2
    x_in = torch.from_numpy(x_q)
    if src == "bf16":  # ~1.5 % of the values past the clip at 127 * s_x = 1.4
        h_in = jnp.asarray(rng.normal(0, 0.6, x_q.shape), jnp.bfloat16)
        x_q = np.asarray(jnp.clip(jnp.round(h_in.astype(jnp.float32) * (1.0 / s_x)),
                                  -127.0, 127.0).astype(jnp.int8))
        x_in = torch.from_numpy(np.array(h_in.astype(jnp.float32))).to(torch.bfloat16)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), window_strides=(stride, stride),
        padding=[(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    h = _act_jax(y.astype(jnp.float32) * (jnp.float32(s_x) * jnp.asarray(w_scale))
                 + jnp.asarray(b), act)
    want_bf16 = np.asarray(h.astype(jnp.bfloat16).astype(jnp.float32))
    want_i8 = np.asarray(jnp.clip(jnp.round(h * (1.0 / jnp.float32(s_next))),
                                  -127.0, 127.0).astype(jnp.int8))

    args = (x_in, tint8.pack_weight(w_q), torch.from_numpy(w_scale), torch.from_numpy(b))
    kw = {"ksize": k, "stride": stride, "s_x": float(s_x), "activation": act,
          "inv_s_x": float(np.float32(1.0) / s_x)}
    got_i32 = tint8.int8_conv(*args, out="int32", **kw)
    assert got_i32.dtype == torch.int32
    np.testing.assert_array_equal(got_i32.numpy(), np.asarray(y))
    got_bf16 = tint8.int8_conv(*args, **kw).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want_bf16), 1e-30))) - 7)
    assert (np.abs(got_bf16 - want_bf16) <= ulp).all()
    inv = float(np.float32(1.0) / s_next)
    got_i8 = tint8.int8_conv(*args, out="int8", inv_s_next=inv, **kw).numpy()
    assert got_i8.dtype == np.int8
    assert np.abs(got_i8.astype(np.int32) - want_i8.astype(np.int32)).max() <= 1


def test_quantize_input_matches_jax():
    """clip(round(h * (1/s_x)), -127, 127) with the float32 reciprocal:
    bf16 inputs on exact rounding ties go the same way (half to even)."""
    s_x = np.float32(0.5 / 127.0)
    inv = np.float32(1.0) / s_x
    vals = np.concatenate([np.arange(-130, 131) / inv, np.linspace(-0.6, 0.6, 999)])
    h = jnp.asarray(vals, jnp.bfloat16)
    want = np.asarray(jnp.clip(jnp.round(h.astype(jnp.float32) * (1.0 / jnp.float32(s_x))),
                               -127.0, 127.0).astype(jnp.int8))
    got = tint8.quantize_input(torch.from_numpy(np.array(h.astype(jnp.float32)))
                               .to(torch.bfloat16), float(inv))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["x_dtype", "w_cols", "scale_dtype", "c_in", "ksize",
                                  "out", "activation", "c_in_int8_3x3", "f32_without_inv_s_x"])
def test_int8_wrapper_rejects(case):
    """A float32 x is taken with its inv_s_x (test_torch_port_f32_contracts.py)
    and refused without one; float64 is not taken at all."""
    x = torch.zeros((1, 8, 8, 256), dtype=torch.int8)
    w = torch.zeros((64, 9 * 256), dtype=torch.int8)
    s, b = torch.ones(64), torch.zeros(64)
    kw = {"ksize": 3, "stride": 1, "s_x": 0.1, "activation": "mish", "out": "bf16"}
    if case == "x_dtype":
        x, kw["inv_s_x"] = x.double(), 10.0
    elif case == "f32_without_inv_s_x":
        x = x.float()
    elif case == "w_cols":
        w = w[:, :-1].contiguous()
    elif case == "scale_dtype":
        s = s.double()
    elif case == "c_in":
        x, w = x[..., :8].contiguous(), w[:, :72].contiguous()
    elif case == "ksize":
        kw["ksize"] = 5
    elif case == "out":
        kw["out"] = "fp8"
    elif case == "activation":
        kw["activation"] = "gelu"
    elif case == "c_in_int8_3x3":  # an int8 3x3 input takes 128-channel steps
        x, w = x[..., :144].contiguous(), w[:, :9 * 144].contiguous()
    with pytest.raises((TypeError, ValueError)):
        tint8.int8_conv(x, w, s, b, **kw)


def test_path2_routes_at_608():
    """The serving path of chip_smoke.py's path 2: complex_yolov4 at 608
    with int8 by `default_skip` and fused stages sends layer 0 to the stem
    kernel, layers 1 and 11 to the 3x3 kernel, layers 2-10 and 12-23 to two
    fused-stage launches and 68 convs to the int8 kernel."""
    spec = zoo.get_model_spec("complex_yolov4")
    params, state = weights.init_params_np(spec, 0)
    folded = weights.fold_batchnorm(spec, params, state)
    tree = tqz.make_quant(spec, folded, {f"layer{i}": 1.0 for i in range(len(spec.layers))})
    model = Darknet(spec, weights.from_folded(spec, folded), compute_dtype=torch.bfloat16,
                    device=torch.device("cpu"), quant=weights.from_jax_quant(spec, tree),
                    fused_stages=True)
    routes = model.routes(608)
    by_kind = {}
    for i, r in routes.items():
        by_kind.setdefault(r, []).append(i)
    assert by_kind["stem"] == [0] and by_kind["conv3x3"] == [1, 11]
    assert by_kind["fused_stage 2-10"] == list(range(2, 11))
    assert by_kind["fused_stage 12-23"] == list(range(12, 24))
    assert len(by_kind["int8"]) == 68 and len(model._chain) == 30
    assert sorted(model.segments(608)) == [2, 12]
