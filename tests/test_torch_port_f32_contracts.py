"""The int8 conv's f32 contract on the CPU: an f32 input is quantized as
the JAX int8 branch quantizes it, and the f32 network hands it to the
int8 conv as it is.

- `int8_conv` (its plain version on a CPU tensor) with an f32 x equals
  `quantize_input`, then the int8 x, bit for bit in every output mode;
  `quantize_input` of f32 values at the clip and on exact half-steps (ties
  to even) equals the JAX branch's `clip(round(h * (1/s_x)))`
  (`network.py:477-482`).
- `Darknet._int8_conv` passes the f32 activation to `int8_conv` unchanged
  (the kernel quantizes it), and int8 from a chained producer.
- The f32 int8 network (complex_yolov4_tiny at 128, f32 compute, int8 on
  `default_skip`'s convs) against the JAX executor's int8 branch in f32 on
  the same weights and quant tree: decoded heads within 1e-4 of each
  column's scale, the bound of the f32 network without int8
  (test_torch_port_network.py; this case reads 8.7e-7). Both quantize the
  same f32 activations, but XLA and torch sum the f32 convs in other
  orders (about 1e-6 relative), which could move an activation lying
  within that of a half-step by one int8 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu.models import quantize as jqz
from complex_yolov4_tpu_torch.models import quantize as tqz
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.ops import int8_conv as tint8
from tests._torch_port_util import image, nchw, rel_err

CPU = torch.device("cpu")


def _f32_input(rng, shape, s_x):
    """N(0, 40 s_x) values (about 2 % past the clip at 127 s_x), a quarter
    of them moved onto exact half-steps (n + 1/2) s_x, n in -130..129 (s_x a
    power of two, so x * (1/s_x) is exact and lands on the tie)."""
    x = rng.normal(0.0, 40.0 * s_x, shape).astype(np.float32)
    ties = rng.random(shape) < 0.25
    x[ties] = ((rng.integers(-130, 130, shape) + 0.5) * s_x).astype(np.float32)[ties]
    return x


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_f32_input_is_quantize_then_int8(k, stride):
    rng = np.random.default_rng(100 + 10 * k + stride)
    c_in, c_out = 32, 24
    s_x = np.float32(2.0 ** -6)
    inv_s_x = float(np.float32(1.0) / s_x)
    x = _f32_input(rng, (2, 9, 9, c_in), s_x)
    want_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / jnp.float32(s_x))),
                                 -127.0, 127.0).astype(jnp.int8))
    x_q = tint8.quantize_input(torch.from_numpy(x), inv_s_x)
    np.testing.assert_array_equal(x_q.numpy(), want_q)
    assert (np.abs(want_q) == 127).any() and (want_q % 2 == 0).mean() > 0.5  # clip, ties to even

    w = torch.from_numpy(rng.integers(-127, 128, (c_out, k * k * c_in)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, c_out).astype(np.float32))
    b = torch.from_numpy(rng.normal(0.0, 0.5, c_out).astype(np.float32))
    kw = {"ksize": k, "stride": stride, "s_x": float(s_x), "activation": "mish",
          "inv_s_x": inv_s_x}
    for out in tint8.OUT_MODES:
        extra = {"out": out, "inv_s_next": 31.0}
        got = tint8.int8_conv(torch.from_numpy(x), w, scale, b, **extra, **kw)
        want = tint8.int8_conv_plain(x_q, w, scale, b, **extra, **kw)
        assert got.dtype == want.dtype == tint8._OUT_DTYPES[out]
        assert torch.equal(got, want), out


def _tiny_quant_model(size, dtype):
    spec = zoo.get_model_spec("complex_yolov4_tiny", width=size, height=size)
    params, state = weights.init_params_np(spec, 0)
    folded = weights.fold_batchnorm(spec, params, state)
    tree = tqz.make_quant(spec, folded, {f"layer{i}": 4.0 for i in range(len(spec.layers))})
    return Darknet(spec, weights.from_folded(spec, folded), compute_dtype=dtype, device=CPU,
                   quant=weights.from_jax_quant(spec, tree))


def test_int8_conv_gets_the_f32_activation(monkeypatch):
    model = _tiny_quant_model(64, torch.float32)
    assert model._quant and model._chain
    seen = []
    plain = tint8.int8_conv

    def spy(x, *args, **kw):
        seen.append(x.dtype)
        return plain(x, *args, **kw)

    monkeypatch.setattr(tint8, "int8_conv", spy)
    calls = []
    real = Darknet._int8_conv

    def checked(self, i, h, kernels):
        calls.append((i, h.dtype))
        n = len(seen)
        y = real(self, i, h, kernels)
        assert len(seen) == n + 1
        return y

    monkeypatch.setattr(Darknet, "_int8_conv", checked)
    with torch.inference_mode():
        model(nchw(image(1, 64)))
    assert len(calls) == len(model._quant) == len(seen)
    for (i, h_dtype), x_dtype in zip(calls, seen):
        assert x_dtype == h_dtype  # handed over as it is, not quantized first
        chained_in = i - 1 in model._chain
        assert x_dtype == (torch.int8 if chained_in else torch.float32), (i, x_dtype)


def test_f32_int8_network_matches_jax():
    size = 128
    spec = zoo.get_model_spec("complex_yolov4_tiny", width=size, height=size)
    params, state = weights.init_params_np(spec, 2)
    jspec = get_model_spec("complex_yolov4_tiny", width=size, height=size)
    fparams = jnet.fold_batchnorm(jspec, params, state)
    folded = {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])} for k, v in fparams.items()}
    x = image(2, size, seed=4)
    act_max = tqz.calibrate(spec, folded, [x], device=CPU)
    jquant = jqz.make_quant(jspec, fparams, act_max)
    quant_np = {k: {f: np.asarray(v) for f, v in e.items()} for k, e in jquant.items()}

    want, _ = jax.jit(lambda p, q, xx: jnet.apply(
        jnet.fold_spec(jspec), p, {}, xx, compute_dtype=jnp.float32, use_pallas_conv=False,
        stem_pallas=False, use_fused_stage=False, quant=q, batch_pack=None))(
            fparams, jquant, jnp.asarray(x))
    want = np.asarray(want)
    model = Darknet(spec, weights.from_folded(spec, folded), compute_dtype=torch.float32,
                    device=CPU, quant=weights.from_jax_quant(spec, quant_np))
    assert sum(r == "int8" for r in model.routes(size).values()) == len(quant_np) > 0
    with torch.inference_mode():
        got = model(nchw(x)).numpy()
    assert got.shape == want.shape == (2, spec.num_boxes(size), 10)
    assert np.isfinite(got).all()
    err = rel_err(got, want)
    assert err < 1e-4, err
