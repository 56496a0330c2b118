"""Train-mode BatchNorm with a bf16 residual, as an autograd Function.

Counterpart of `complex_yolov4_tpu/models/bn_train.py` `bn_train` with
p = 1 (batch packing is a TPU layout rewrite the port leaves out). It
computes f32 batch statistics of the bf16 conv output, the f32 normalize,
and the exact train-mode gradient through the batch mean and variance, but
saves only the bf16 input (plus per-channel f32 scalars) for the backward,
which recomputes xhat from it: the input is bf16, so recomputing loses
nothing over keeping its f32 cast, and the saved bytes halve. An f32 input
takes the same path (its residual is f32): `TrainDarknet` runs every
train-mode BN through it, in both compute dtypes.

With a process group (data parallel, `parallel.wrap_ddp`), the statistics
are those of the global batch, as a jitted JAX step on a data mesh computes
them: the forward all-reduces the per-channel sum, then the sum of squared
deviations from the global mean (f32, two passes, as `var` computes it on
one process); the backward all-reduces the sums of g and g * xhat, so that
dx is the global-batch gradient. Every rank's batch has the same shape (the
loader's static shapes; the multiscale size is drawn alike on every rank),
so the global count is the rank's times the world size. The scale and bias
gradients stay the rank's own sums: DDP's gradient all-reduce adds them
up like every other parameter's.

Layout: NCHW activations (channels_last memory or not); statistics reduce
over (N, H, W).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BN_EPS = 1e-5  # torch BatchNorm2d default, the JAX package's too
_DIMS = (0, 2, 3)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def batch_count(h: torch.Tensor, group=None) -> int:
    """The element count per channel of the batch: the rank's (N*H*W), times
    the world size with a group."""
    n = h.shape[0] * h.shape[2] * h.shape[3]
    return n * dist.get_world_size(group) if group is not None else n


def _batch_stats(hf: torch.Tensor, group):
    """(mean (C,), biased var (C,)) of f32 `hf` over (N, H, W): the rank's
    own without a group, the global batch's with one."""
    if group is None:
        return hf.mean(_DIMS), hf.var(_DIMS, unbiased=False)
    n = batch_count(hf, group)
    s = hf.sum(_DIMS)
    dist.all_reduce(s, group=group)
    mean = s / n
    m2 = ((hf - _bcast(mean)) ** 2).sum(_DIMS)
    dist.all_reduce(m2, group=group)
    return mean, m2 / n


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, scale, bias, group):
        hf = h.float()
        mean, var = _batch_stats(hf, group)
        inv = torch.rsqrt(var + BN_EPS)
        eff = inv * scale
        y = (hf * _bcast(eff) + _bcast(bias - mean * eff)).to(h.dtype)
        ctx.save_for_backward(h, scale, mean, inv)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g_y, _g_mean, _g_var):
        h, scale, mean, inv = ctx.saved_tensors
        g = g_y.float()
        xhat = (h.float() - _bcast(mean)) * _bcast(inv)
        n = batch_count(h, ctx.group)
        sum_g = g.sum(_DIMS)
        sum_gx = (g * xhat).sum(_DIMS)
        tot_g, tot_gx = sum_g, sum_gx
        if ctx.group is not None:
            sums = torch.cat([sum_g, sum_gx])
            dist.all_reduce(sums, group=ctx.group)
            tot_g, tot_gx = sums.split(sum_g.shape[0])
        # exact train-mode BN gradient (through the batch statistics):
        #   dx = inv*scale * (g - mean(g) - xhat * mean(g*xhat))
        dx = _bcast(inv * scale) * (g - _bcast(tot_g / n) - xhat * _bcast(tot_gx / n))
        return dx.to(h.dtype), sum_gx, sum_g, None


def bn_train(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, group=None):
    """(h (B, C, H, W) in the compute dtype, scale (C,) f32, bias (C,) f32) ->
    (normalized h in h.dtype, batch mean (C,) f32, biased batch var (C,)
    f32). The statistics feed the running-statistics update only and carry
    no gradient. group: a process group whose ranks' batches together
    form the batch (None: this process's batch alone)."""
    return _BNTrain.apply(h, scale, bias, group)
