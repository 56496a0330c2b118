"""int8 convolution with the fused dequant / bias / activation epilogue.

Counterpart of the int8 branch of `complex_yolov4_tpu/models/network.py`
`apply` (lines 456-501), which XLA computes on the TPU (there is no Pallas
original; torch has no int8 conv2d on CUDA):

    y_i32 = conv(x_i8, w_i8)                  k in {1, 3}, stride 1 or 2,
                                              symmetric padding (k-1)/2
    h     = act(y * (s_x * w_scale) + b)      f32
    out   = bf16(h), or for a chained producer
            clip(round(h * (1/s_x_next)), -127, 127) as int8 (half to even)

`int8_conv` is the wrapper: a CUDA tensor goes to the hand-written Hopper
kernel (`csrc/int8_conv.cu`, `cyv4_int8_conv`) or the call raises; a CPU
tensor goes to `int8_conv_plain`, the plain PyTorch version (an exact int32
conv from a float64 conv of the int8-valued tensors, |sum| <= 9 * 2048 *
127^2 < 2^53, then the same f32 epilogue as separate ops).

`quantize_input` is the plain elementwise pass that brings a bf16
activation to a non-chained conv's int8 domain, as `network.py:480-482`.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import ACT_CODES, act
from .conv3x3 import im2col_nhwc

OUT_MODES = {"bf16": 0, "int8": 1, "int32": 2}


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
    return h.to(torch.bfloat16)


def int8_conv_plain(x_q, w_q, w_scale, bias, *, ksize, stride, s_x, activation,
                    out="bf16", inv_s_next=0.0):
    """Plain PyTorch version of the kernel, on x_q's device."""
    y = conv_int32_plain(x_q, w_q, ksize=ksize, stride=stride)
    return epilogue(y, w_scale, bias, s_x=s_x, activation=activation, out=out,
                    inv_s_next=inv_s_next)


def _check(x_q, w_q, w_scale, bias, ksize, stride, activation, out):
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise TypeError(f"x_q must be (B, H, W, C_in) int8, got {tuple(x_q.shape)} {x_q.dtype}")
    c_in = x_q.shape[-1]
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
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if out not in OUT_MODES:
        raise ValueError(f"out must be one of {sorted(OUT_MODES)}")
    if not all(t.is_contiguous() for t in (x_q, w_q, w_scale, bias)):
        raise ValueError("x_q, w_q, w_scale and bias must be contiguous")
    if not (x_q.device == w_q.device == w_scale.device == bias.device):
        raise ValueError("x_q, w_q, w_scale and bias must lie on one device")
    if x_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_q.device}")


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor, *, ksize: int, stride: int, s_x: float,
              activation: str, out: str = "bf16", inv_s_next: float = 0.0) -> torch.Tensor:
    """int8 conv + epilogue, NHWC.

    Args:
      x_q: (B, H, W, C_in) int8, contiguous, C_in % 16 == 0.
      w_q: (C_out, k*k*C_in) int8 from `pack_weight`.
      w_scale, bias: (C_out,) float32.
      s_x: the input's scale (a float32 value); inv_s_next: the float32
        reciprocal of the consumer's s_x, for out="int8".
      out: "bf16", "int8" (chained requantization) or "int32" (the raw sum).
    Returns (B, Ho, Wo, C_out) of the out dtype.
    """
    _check(x_q, w_q, w_scale, bias, ksize, stride, activation, out)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, w_scale, bias, ksize=ksize, stride=stride,
                               s_x=s_x, activation=activation, out=out,
                               inv_s_next=inv_s_next)
    b, h, w, c_in = x_q.shape
    c_out = w_q.shape[0]
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "int32": torch.int32}[out]
    y = torch.empty((b, out_size(h, ksize, stride), out_size(w, ksize, stride), c_out),
                    dtype=dtype, device=x_q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    code = lib.cyv4_int8_conv(x_q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                              bias.data_ptr(), y.data_ptr(), b, h, w, c_in, c_out, ksize,
                              stride, float(s_x), ACT_CODES[activation], OUT_MODES[out],
                              float(inv_s_next), stream)
    _build.check(code, "cyv4_int8_conv")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0  # kernel launches, read by chip_smoke.py
