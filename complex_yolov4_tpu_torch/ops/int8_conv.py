"""int8 convolution with the fused dequant / bias / activation epilogue.

Counterpart of the int8 branch of `complex_yolov4_tpu/models/network.py`
`apply` (lines 456-501), which XLA computes on the TPU (there is no Pallas
original; torch has no int8 conv2d on CUDA):

    x_q   = x, or for a bf16 or f32 x         network.py:480-482
            clip(round(x * (1/s_x)), -127, 127) as int8 (half to even)
    y_i32 = conv(x_q, w_i8)                   k in {1, 3}, stride 1 or 2,
                                              symmetric padding (k-1)/2
    h     = act(y * (s_x * w_scale) + b)      f32
    out   = h cast to the compute dtype: bf16(h), or h in f32 compute
            (network.py:496), or for a chained producer
            clip(round(h * (1/s_x_next)), -127, 127) as int8 (half to even)

`int8_conv` is the wrapper: a CUDA tensor goes to the hand-written Hopper
kernel (`csrc/int8_conv.cu`, `cyv4_int8_conv`), which quantizes a bf16 or
f32 input on its way into shared memory, or the call raises; a CPU tensor
goes to `int8_conv_plain`, the plain PyTorch version (`quantize_input`,
then an exact int32 conv from a float64 conv of the int8-valued tensors,
|sum| <= 9 * 2048 * 127^2 < 2^53, then the same f32 epilogue as separate
ops).

`quantize_input` is the plain elementwise pass that brings a bf16 or f32
activation to a non-chained conv's int8 domain, as `network.py:480-482`;
only the plain version runs it.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import ACT_CODES, act
from .conv3x3 import im2col_nhwc

OUT_MODES = {"bf16": 0, "int8": 1, "int32": 2, "f32": 3}
# the kernel's input dtype codes (Int8ConvArgs.x_dtype); bf16 and f32 are
# quantized with inv_s_x
X_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def quantize_input(h: torch.Tensor, inv_s_x: float) -> torch.Tensor:
    """clip(round(h * inv_s_x), -127, 127) as int8, in f32 (round half to
    even). `inv_s_x` is the float32 reciprocal of s_x, taken in float32."""
    return torch.clamp(torch.round(h.float() * inv_s_x), -127.0, 127.0).to(torch.int8)


def pack_weight(w_hwio) -> torch.Tensor:
    """(k, k, C_in, C_out) int8 HWIO -> (C_out, k*k*C_in) int8, columns in
    (ky, kx, ci) order."""
    w = torch.as_tensor(w_hwio)
    return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1).contiguous()


def out_size(h: int, ksize: int, stride: int) -> int:
    pad = (ksize - 1) // 2
    return (h + 2 * pad - ksize) // stride + 1


def conv_int32_plain(x_q: torch.Tensor, w_q: torch.Tensor, *, ksize: int,
                     stride: int) -> torch.Tensor:
    """Exact int32 conv (B, Ho, Wo, C_out) of int8 NHWC x_q and packed w_q,
    by a float64 im2col matmul (every partial sum is an integer < 2^53)."""
    x = x_q.double()
    if ksize == 1:
        patches = x[:, ::stride, ::stride, :] if stride > 1 else x
    else:
        patches = im2col_nhwc(x, stride)
    return torch.round(patches @ w_q.double().t()).to(torch.int32)


def epilogue(y: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor, *, s_x: float,
             activation: str, out: str, inv_s_next: float = 0.0) -> torch.Tensor:
    """The f32 epilogue of `network.py:489-494` on an int32 sum."""
    if out == "int32":
        return y
    scale = torch.tensor(s_x, dtype=torch.float32, device=y.device) * w_scale
    h = act(y.float() * scale + bias, activation)
    if out == "int8":
        return torch.clamp(torch.round(h * inv_s_next), -127.0, 127.0).to(torch.int8)
    return h if out == "f32" else h.to(torch.bfloat16)


def int8_conv_plain(x, w_q, w_scale, bias, *, ksize, stride, s_x, activation,
                    out="bf16", inv_s_next=0.0, inv_s_x=None):
    """Plain PyTorch version of the kernel, on x's device: a bf16 or f32 x
    is quantized with `inv_s_x` first."""
    x_q = x if x.dtype == torch.int8 else quantize_input(x, inv_s_x)
    y = conv_int32_plain(x_q, w_q, ksize=ksize, stride=stride)
    return epilogue(y, w_scale, bias, s_x=s_x, activation=activation, out=out,
                    inv_s_next=inv_s_next)


_OUT_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "int32": torch.int32,
               "f32": torch.float32}


def _check(x, w_q, w_scale, bias, ksize, stride, activation, out, inv_s_x):
    if x.dim() != 4 or x.dtype not in X_DTYPES:
        raise TypeError(f"x must be (B, H, W, C_in) int8, bf16 or f32, got {tuple(x.shape)} "
                        f"{x.dtype}")
    if x.dtype != torch.int8 and inv_s_x is None:
        raise ValueError(f"a {x.dtype} x needs inv_s_x, the float32 reciprocal of its scale")
    c_in = x.shape[-1]
    if ksize not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"ksize {ksize}, stride {stride}: need k in (1, 3), stride 1 or 2")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != ksize * ksize * c_in:
        raise ValueError(f"w_q must be (C_out, {ksize * ksize * c_in}) int8, got "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    c_out = w_q.shape[0]
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c_out,):
            raise ValueError(f"{name} must be ({c_out},) float32")
    if c_in % 16 or c_out % 8:
        raise ValueError(f"C_in {c_in} must be a multiple of 16, C_out {c_out} of 8")
    if x.dtype == torch.int8 and (ksize, stride) != (1, 1) and c_in % 128:
        raise ValueError(f"an int8 x of a {ksize}x{ksize} stride-{stride} conv needs C_in % 128 "
                         f"== 0 (one tap per 128-channel step), got {c_in}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if out not in OUT_MODES:
        raise ValueError(f"out must be one of {sorted(OUT_MODES)}")
    if not all(t.is_contiguous() for t in (x, w_q, w_scale, bias)):
        raise ValueError("x, w_q, w_scale and bias must be contiguous")
    if not (x.device == w_q.device == w_scale.device == bias.device):
        raise ValueError("x, w_q, w_scale and bias must lie on one device")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must start at a 16-byte boundary")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor, *, ksize: int, stride: int, s_x: float,
              activation: str, out: str = "bf16", inv_s_next: float = 0.0,
              inv_s_x: float = None) -> torch.Tensor:
    """int8 conv + epilogue, NHWC.

    Args:
      x: (B, H, W, C_in) int8 (already in the conv's int8 domain), bf16 or
        f32 (quantized with `inv_s_x` inside the kernel), contiguous, C_in %
        16 == 0; C_in % 128 == 0 for an int8 x of a 3x3 or strided conv
        (every quantized conv of the four topologies has C_in % 128 == 0).
      w_q: (C_out, k*k*C_in) int8 from `pack_weight`.
      w_scale, bias: (C_out,) float32.
      s_x: the input's scale (a float32 value); inv_s_x: its float32
        reciprocal, for a bf16 or f32 x; inv_s_next: the float32 reciprocal of the
        consumer's s_x, for out="int8".
      out: "bf16", "f32" (f32 compute), "int8" (chained requantization) or
        "int32" (the raw sum).
    Returns (B, Ho, Wo, C_out) of the out dtype.
    """
    _check(x, w_q, w_scale, bias, ksize, stride, activation, out, inv_s_x)
    if not x.is_cuda:
        return int8_conv_plain(x, w_q, w_scale, bias, ksize=ksize, stride=stride,
                               s_x=s_x, activation=activation, out=out,
                               inv_s_next=inv_s_next, inv_s_x=inv_s_x)
    b, h, w, c_in = x.shape
    c_out = w_q.shape[0]
    y = torch.empty((b, out_size(h, ksize, stride), out_size(w, ksize, stride), c_out),
                    dtype=_OUT_DTYPES[out], device=x.device)
    lib = _build.load()
    x_dtype = X_DTYPES[x.dtype]
    dev = x.get_device()
    code = lib.cyv4_int8_conv(_build.Int8ConvArgs(
        x.data_ptr(), x_dtype, w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, h, w, c_in, c_out, ksize, stride, s_x, inv_s_x if x_dtype else 0.0,
        ACT_CODES[activation], OUT_MODES[out], inv_s_next,
        torch._C._cuda_getCurrentRawStream(dev), dev))
    if code:
        _build.check(code, "cyv4_int8_conv")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0  # kernel launches, read by chip_smoke.py
