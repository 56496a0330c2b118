"""Port kernels' plain versions vs the JAX Pallas kernels in interpret mode.

On the CPU the wrappers `conv3x3_stem` and `conv3x3_fused` take the plain
PyTorch version of their CUDA kernel (im2col + one f32 matmul of
bf16-rounded operands, f32 epilogue, bf16 out). The Pallas kernels run in
interpret mode, as tests/test_stem_conv.py and tests/test_pallas_conv.py
run them. Both compute bf16 products with f32 accumulation and an f32
epilogue; only the summation order differs, so they agree to about one
bf16 ulp — held at rtol/atol 2e-2, the JAX tests' tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.ops import pallas_conv, stem_conv
from complex_yolov4_tpu_torch.ops import conv3x3 as tconv
from complex_yolov4_tpu_torch.ops import stem_conv as tstem


def _torch_operands(x, w, bias, x_dtype):
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    return (torch.from_numpy(x).to(x_dtype), tconv.pack_weight(w_oihw),
            torch.from_numpy(bias))


@pytest.mark.parametrize("c_in,c_out,activation", [
    (3, 32, "mish"), (6, 64, "leaky"), (12, 128, "linear")])
def test_stem_plain_matches_pallas(c_in, c_out, activation):
    rng = np.random.default_rng(c_in)
    b, h, w_in = 2, 16, 160
    x = rng.standard_normal((b, h, w_in, c_in)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c_in, c_out)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    ref = np.asarray(stem_conv.conv3x3_stem(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), activation=activation,
        interpret=True), np.float32)
    xt, wt, bt = _torch_operands(x, w, bias, torch.float32)
    got = tstem.conv3x3_stem(xt, wt, bt, activation=activation)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    # the zero channels the CUDA wrappers pad C_in with leave the function as it is
    padded = tstem.stem_plain(*tconv.pad_channels(xt, wt, tstem.MAX_C_IN), bt,
                              activation=activation)
    np.testing.assert_allclose(padded.float().numpy(), ref, rtol=2e-2, atol=2e-2)


def test_stem_plain_edges_exact():
    """All-ones input: SAME-padding mistakes show as integer differences."""
    x = np.ones((1, 8, 128, 3), np.float32)
    w = np.ones((3, 3, 3, 8), np.float32)
    bias = np.zeros(8, np.float32)
    ref = np.asarray(stem_conv.conv3x3_stem(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), activation="linear",
        interpret=True), np.float32)
    got = tstem.conv3x3_stem(*_torch_operands(x, w, bias, torch.float32),
                             activation="linear").float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 4, 64, 0] == 27.0 and got[0, 4, 0, 0] == 18.0
    assert got[0, 0, 0, 0] == 12.0 and got[0, 7, 127, 0] == 12.0


@pytest.mark.parametrize("b,h,cin,cout,stride,act", [
    (2, 256, 32, 64, 1, "mish"), (2, 256, 32, 64, 2, "leaky")])
def test_conv3x3_plain_matches_pallas(b, h, cin, cout, stride, act):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, h, h, cin)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    ref = np.asarray(pallas_conv.conv3x3_fused(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(bias),
        stride=stride, activation=act, interpret=True), np.float32)
    got = tconv.conv3x3_fused(*_torch_operands(x, w, bias, torch.bfloat16),
                              stride=stride, activation=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)


def test_pack_weight_row_order():
    """Row (ky*3 + kx)*C_in + ci of the packed weight is w[ky, kx, ci, :]."""
    w = np.random.default_rng(0).integers(-128, 128, (3, 3, 5, 8)).astype(np.float32)
    packed = tconv.pack_weight(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(packed.float().numpy(),
                                  w.reshape(45, 8))


def _operands(x_dtype, c_in=32, c_out=64, hw=256):
    x = torch.zeros((1, hw, hw, c_in), dtype=x_dtype)
    w = torch.zeros((9 * c_in, c_out), dtype=torch.bfloat16)
    return x, w, torch.zeros(c_out)


@pytest.mark.parametrize("case", ["x_dtype", "w_dtype", "bias_dtype", "w_rows",
                                  "envelope", "stride", "activation", "layout"])
def test_conv3x3_wrapper_rejects(case):
    x, w, b = _operands(torch.bfloat16)
    kw = {"stride": 1, "activation": "mish"}
    if case == "x_dtype":
        x = x.half()  # neither bf16 nor f32, the two dtypes the kernel takes
    elif case == "w_dtype":
        w = w.float()
    elif case == "bias_dtype":
        b = b.half()
    elif case == "w_rows":
        w = w[:-1]
    elif case == "envelope":
        x, w, b = _operands(torch.bfloat16, hw=64)  # W_out < 128
    elif case == "stride":
        kw["stride"] = 3
    elif case == "activation":
        kw["activation"] = "gelu"
    elif case == "layout":
        x = x.permute(0, 2, 1, 3)  # not contiguous
    with pytest.raises((TypeError, ValueError)):
        tconv.conv3x3_fused(x, w, b, **kw)


@pytest.mark.parametrize("case", ["x_dtype", "c_in", "c_out"])
def test_stem_wrapper_rejects(case):
    x, w, b = _operands(torch.float32, c_in=3, c_out=32, hw=32)
    if case == "x_dtype":
        x = x.to(torch.bfloat16)
    elif case == "c_in":
        x, w, b = _operands(torch.float32, c_in=16, c_out=32, hw=32)
    elif case == "c_out":
        x, w, b = _operands(torch.float32, c_in=3, c_out=36, hw=32)
    with pytest.raises((TypeError, ValueError)):
        tstem.conv3x3_stem(x, w, b, activation="mish")
