"""Train-mode BatchNorm with a bf16 residual, as an autograd Function.

Counterpart of `complex_yolov4_tpu/models/bn_train.py` `bn_train` with
p = 1 (batch packing is a TPU layout rewrite the port leaves out). It
computes f32 batch statistics of the bf16 conv output, the f32 normalize,
and the exact train-mode gradient through the batch mean and variance, but
saves only the bf16 input (plus per-channel f32 scalars) for the backward,
which recomputes xhat from it: the input is bf16, so recomputing loses
nothing over keeping its f32 cast, and the saved bytes halve.

Layout: NCHW activations (channels_last memory or not); statistics reduce
over (N, H, W).
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5  # torch BatchNorm2d default, the JAX package's too
_DIMS = (0, 2, 3)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, scale, bias):
        hf = h.float()
        mean = hf.mean(_DIMS)
        var = hf.var(_DIMS, unbiased=False)
        inv = torch.rsqrt(var + BN_EPS)
        eff = inv * scale
        y = (hf * _bcast(eff) + _bcast(bias - mean * eff)).to(h.dtype)
        ctx.save_for_backward(h, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g_y, _g_mean, _g_var):
        h, scale, mean, inv = ctx.saved_tensors
        g = g_y.float()
        xhat = (h.float() - _bcast(mean)) * _bcast(inv)
        n = h.shape[0] * h.shape[2] * h.shape[3]
        sum_g = g.sum(_DIMS)
        sum_gx = (g * xhat).sum(_DIMS)
        # exact train-mode BN gradient (through the batch statistics):
        #   dx = inv*scale * (g - mean(g) - xhat * mean(g*xhat))
        dx = _bcast(inv * scale) * (g - _bcast(sum_g / n) - xhat * _bcast(sum_gx / n))
        return dx.to(h.dtype), sum_gx, sum_g


def bn_train(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """(h (B, C, H, W) in the compute dtype, scale (C,) f32, bias (C,) f32) ->
    (normalized h in h.dtype, batch mean (C,) f32, biased batch var (C,)
    f32). The statistics feed the running-statistics update only and carry
    no gradient."""
    return _BNTrain.apply(h, scale, bias)
