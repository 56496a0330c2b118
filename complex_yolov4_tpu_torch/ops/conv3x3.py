"""Fused 3x3 convolution for small-channel, high-resolution layers.

Counterpart of `complex_yolov4_tpu/ops/pallas_conv.py` `conv3x3_fused`:
y = act(conv3x3_pad1(x, w) + b) at stride 1 or 2, bf16 products with f32
accumulation, f32 bias and activation, the output in x's dtype. A bf16 x
gives a bf16 output; an f32 x is rounded to bf16 for the products
(`pallas_conv.py:140`) and gives an f32 output (`:161`). On the early
backbone of complex_yolov4 at 608 it takes layers 1, 6, 11, 16 and 19.

The kernel is the `torch.library` custom op ``cyv4::conv3x3`` (one op for
both dtypes), so that `torch.export` can trace a network that calls it:
its CUDA implementation launches the hand-written Hopper kernel
(`csrc/conv3x3.cu`, `cyv4_conv3x3` for bf16, `cyv4_conv3x3_f32` for f32)
or raises; its CPU implementation is `conv3x3_plain`, the plain PyTorch
version of the same function (im2col by slicing, then one f32 matmul of
the bf16-rounded operands), which the CPU tests hold against the Pallas
kernel; its fake implementation checks the operands and gives the output's
shape and dtype, and builds nothing. `conv3x3_fused` is the wrapper that
calls the op.

An f32 network routes its 3x3 layers here only while `F32_ENABLED` is
True, as the JAX executor reaches `pallas_conv` only while its `ENABLED`
is (False as shipped): by default f32 compute convolves every layer in
full f32, as XLA does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .activations import ACT_CODES, act

# The switch of the f32 route, mirroring `pallas_conv.ENABLED`: the f32
# contract rounds x and w to bf16 for the products, which moves an f32
# network's heads off an all-f32 forward (PERF.md §6).
F32_ENABLED = False


def channels_ok(c_in: int, c_out: int, size: int, stride: int) -> bool:
    """3x3, stride 1 or 2, C_in <= 128, C_out <= 128 and a multiple of 8
    (a quad of lanes stores whole 8-channel groups)."""
    return (size == 3 and stride in (1, 2) and c_in <= 128 and c_out <= 128
            and c_out % 8 == 0)


def shape_ok(h: int, w: int, c_in: int, c_out: int, size: int, stride: int) -> bool:
    """The envelope the executor routes through this kernel: `channels_ok`
    and W_out >= 128 — `pallas_conv.shape_ok` without its TPU-only row-tile
    term."""
    return (channels_ok(c_in, c_out, size, stride) and h % stride == 0
            and w % stride == 0 and w // stride >= 128)


def pack_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3) -> (9*C_in, C_out) bf16, rows in (ky, kx, ci)
    order — the layout of `pallas_conv.py:120` and `stem_conv.py:163`."""
    c_out, c_in = w_oihw.shape[:2]
    return (w_oihw.permute(2, 3, 1, 0).reshape(9 * c_in, c_out)
            .to(torch.bfloat16).contiguous())


def im2col_nhwc(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, 9*C) patches in (ky, kx, ci) order with
    symmetric 1-px zero padding (output i reads input rows s*i-1..s*i+1);
    Ho = (H - 1) // s + 1, H / s for an even H."""
    b, h, w, c = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride, :]
            for ky in range(3) for kx in range(3)]
    return torch.cat(taps, dim=-1)


def conv3x3_plain(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
                  *, stride: int, activation: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on x's device."""
    patches = im2col_nhwc(x.to(torch.bfloat16).float(), stride)
    y = patches @ w_packed.float() + bias.float()
    return act(y, activation).to(x.dtype)


def pad_channels(x: torch.Tensor, w_packed: torch.Tensor, c_pad: int):
    """x (..., C_in) and w_packed (9*C_in, C_out) with C_in zero-padded to
    c_pad: zero channels against zero weight rows leave every sum as it
    was. Lets the kernels build a few C_in instances and take the rest."""
    c_in = x.shape[-1]
    if c_in == c_pad:
        return x, w_packed
    w = F.pad(w_packed.reshape(9, c_in, -1), (0, 0, 0, c_pad - c_in))
    return F.pad(x, (0, c_pad - c_in)), w.reshape(9 * c_pad, -1)


def check_operands(x, w_packed, bias, stride, activation, x_dtype, envelope):
    """Raise unless the operands are what the kernels take: dtype (one of
    the tuple `x_dtype`), shape,
    contiguity, one CPU or CUDA device, and `envelope(h, w, c_in, c_out,
    stride)`."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C_in), got {tuple(x.shape)}")
    b, h, w, c_in = x.shape
    if x.dtype not in x_dtype:
        raise TypeError(f"x must be one of {x_dtype}, got {x.dtype}")
    if w_packed.dtype != torch.bfloat16 or w_packed.dim() != 2 or w_packed.shape[0] != 9 * c_in:
        raise ValueError(f"w_packed must be (9*C_in={9 * c_in}, C_out) bf16, got "
                         f"{tuple(w_packed.shape)} {w_packed.dtype}")
    c_out = w_packed.shape[1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must be ({c_out},) float32, got {tuple(bias.shape)} {bias.dtype}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if not envelope(h, w, c_in, c_out, stride):
        raise ValueError(f"shape {tuple(x.shape)} -> {c_out} stride {stride} "
                         "is outside the kernel's envelope")
    if not (x.is_contiguous() and w_packed.is_contiguous() and bias.is_contiguous()):
        raise ValueError("x, w_packed and bias must be contiguous")
    if not (x.device == w_packed.device == bias.device):
        raise ValueError("x, w_packed and bias must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


OP = "cyv4::conv3x3"
torch.library.define(OP, "(Tensor x, Tensor w_packed, Tensor bias, int stride, "
                         "str activation) -> Tensor")


def _check(x, w_packed, bias, stride, activation):
    check_operands(x, w_packed, bias, stride, activation, (torch.bfloat16, torch.float32),
                   lambda h, w, ci, co, s: shape_ok(h, w, ci, co, 3, s))


@torch.library.register_fake(OP)
def _fake(x, w_packed, bias, stride, activation):
    _check(x, w_packed, bias, stride, activation)
    b, h, w, _ = x.shape
    return x.new_empty((b, h // stride, w // stride, w_packed.shape[1]))


@torch.library.impl(OP, "CPU")
def _cpu(x, w_packed, bias, stride, activation):
    _check(x, w_packed, bias, stride, activation)
    return conv3x3_plain(x, w_packed, bias, stride=stride, activation=activation)


@torch.library.impl(OP, "CUDA")
def _cuda(x, w_packed, bias, stride, activation):
    _check(x, w_packed, bias, stride, activation)
    # the kernel is built for C_in 32, 64 and 128 (the main path's are 32
    # and 64); any other C_in is zero-padded to the next of them
    x, w_packed = pad_channels(x, w_packed, next(c for c in (32, 64, 128) if c >= x.shape[-1]))
    b, h, w, c_in = x.shape
    c_out = w_packed.shape[1]
    out = torch.empty((b, h // stride, w // stride, c_out), dtype=x.dtype, device=x.device)
    lib = _build.load()
    entry = lib.cyv4_conv3x3 if x.dtype == torch.bfloat16 else lib.cyv4_conv3x3_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = entry(x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 b, h, w, c_in, c_out, stride, ACT_CODES[activation], stream)
    _build.check(code, "cyv4_conv3x3" if x.dtype == torch.bfloat16 else "cyv4_conv3x3_f32")
    conv3x3_fused.launches += 1
    return out


_op = torch.ops.cyv4.conv3x3.default


def conv3x3_fused(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
                  *, stride: int = 1, activation: str = "leaky") -> torch.Tensor:
    """y = act(conv3x3_pad1(x, w) + bias), NHWC, out in x's dtype: the op
    ``cyv4::conv3x3``.

    Args:
      x: (B, H, W, C_in) bfloat16 or float32 (rounded to bf16 for the
        products), contiguous.
      w_packed: (9*C_in, C_out) bfloat16 from `pack_weight`.
      bias: (C_out,) float32.
    Returns (B, H/stride, W/stride, C_out) of x's dtype.
    """
    return _op(x, w_packed, bias, stride, activation)


conv3x3_fused.launches = 0  # kernel launches, read by chip_smoke.py
