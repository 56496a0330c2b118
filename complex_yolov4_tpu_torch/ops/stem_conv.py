"""Stem convolution: 3x3 stride-1 conv for tiny input channel counts.

Counterpart of `complex_yolov4_tpu/ops/stem_conv.py` `conv3x3_stem`:
y = act(conv3x3_pad1_s1(x, w) + b) with x the f32 raster (rounded to bf16
before the products), bf16 weights, f32 accumulation, f32 bias and
activation, bf16 output. On complex_yolov4 it takes layer 0 (3 -> 32, mish).

The kernel is the `torch.library` custom op ``cyv4::stem_conv3x3``: its
CUDA implementation launches the hand-written Hopper kernel
(`csrc/conv3x3.cu`, `cyv4_stem_conv3x3`) or raises; its CPU implementation
is `stem_plain`, the plain PyTorch version (im2col by slicing, then one
f32 matmul of the bf16-rounded operands); its fake implementation checks
the operands and gives the output's shape and dtype, for `torch.export`,
and builds nothing. `conv3x3_stem` is the wrapper that calls the op.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import ACT_CODES
from .conv3x3 import check_operands, conv3x3_plain, pad_channels

MAX_C_IN = 14  # K = 9 * C_in <= 126, the TPU kernel's envelope too


def shape_ok(c_in: int, c_out: int, size: int, stride: int) -> bool:
    """3x3, stride 1, C_in <= 14, C_out a multiple of 8 up to 128 (at most
    four 32-channel groups over the block's 8 warps, each group's weight
    held in registers)."""
    return (size == 3 and stride == 1 and 1 <= c_in <= MAX_C_IN
            and c_out % 8 == 0 and c_out <= 128)


def stem_plain(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
               *, activation: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on x's device: the f32 result of
    `conv3x3_plain` rounded to bf16."""
    return conv3x3_plain(x, w_packed, bias, stride=1, activation=activation).to(torch.bfloat16)


OP = "cyv4::stem_conv3x3"
torch.library.define(OP, "(Tensor x, Tensor w_packed, Tensor bias, str activation) -> Tensor")


def _check(x, w_packed, bias, activation):
    check_operands(x, w_packed, bias, 1, activation, (torch.float32,),
                   lambda h, w, ci, co, s: shape_ok(ci, co, 3, s))


@torch.library.register_fake(OP)
def _fake(x, w_packed, bias, activation):
    _check(x, w_packed, bias, activation)
    return x.new_empty((*x.shape[:3], w_packed.shape[1]), dtype=torch.bfloat16)


@torch.library.impl(OP, "CPU")
def _cpu(x, w_packed, bias, activation):
    _check(x, w_packed, bias, activation)
    return stem_plain(x, w_packed, bias, activation=activation)


@torch.library.impl(OP, "CUDA")
def _cuda(x, w_packed, bias, activation):
    _check(x, w_packed, bias, activation)
    # the kernel is built for C_in 3 (the main path) and 14; any other C_in
    # is zero-padded to 14
    if x.shape[-1] != 3:
        x, w_packed = pad_channels(x, w_packed, MAX_C_IN)
    b, h, w, c_in = x.shape
    c_out = w_packed.shape[1]
    out = torch.empty((b, h, w, c_out), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.cyv4_stem_conv3x3(x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), b, h, w, c_in, c_out,
                                 ACT_CODES[activation], stream)
    _build.check(code, "cyv4_stem_conv3x3")
    conv3x3_stem.launches += 1
    return out


_op = torch.ops.cyv4.stem_conv3x3.default


def conv3x3_stem(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
                 *, activation: str = "mish") -> torch.Tensor:
    """y = act(conv3x3_pad1_s1(x, w) + bias) for tiny C_in: the op
    ``cyv4::stem_conv3x3``.

    Args:
      x: (B, H, W, C_in) float32 raster, contiguous.
      w_packed: (9*C_in, C_out) bfloat16 from `conv3x3.pack_weight`.
      bias: (C_out,) float32.
    Returns (B, H, W, C_out) bfloat16.
    """
    return _op(x, w_packed, bias, activation)


conv3x3_stem.launches = 0  # kernel launches, read by chip_smoke.py
