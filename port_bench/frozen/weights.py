"""Seeded weights, made on the device in a few large calls.

`init_params`: per conv an OIHW weight uniform in +-sqrt(1 / fan_in) and,
with BN, scale U(0.9, 1.1), bias N(0, 0.05), running mean N(0, 0.05) and
variance U(0.8, 1.2); without BN a bias uniform in +-sqrt(1 / fan_in): the
port's `init_params_np` distributions, drawn from a `torch.Generator` on
the device, one call per distribution.

`sighted_folded`: a frozen copy of the port's `models/sighted.py`
`sighted_params_np`, on the device: BN folded (float64, then float32), and
every conv rescaled so that its folded output, before the activation, has
unit RMS on one calibration raster, layer by layer. With the init alone
each conv shrinks its input about 3x against the folded biases, and the
heads carry almost nothing of the early layers; rescaled, every layer's
work reaches the heads.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference import darknet as ref
from .work import conv_shapes

BN_EPS = 1e-5


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit torch seed from the run's seed and a stream number."""
    state = np.random.SeedSequence((int(seed), 100 + int(stream))).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def conv_dims(layers: List[dict], in_channels: int = 3) -> Dict[int, tuple]:
    """{conv index: (c_out, c_in, k, bn)}."""
    return {i: (s["c_out"], s["c_in"], s["k"], bool(layers[i]["bn"]))
            for i, s in conv_shapes(layers, 608, in_channels).items()}


def init_params(layers: List[dict], seed: int, device) -> Dict[int, dict]:
    """{conv index: {"w", and "bn_scale", "bn_bias", "mean", "var" | "b"}}, f32."""
    dims = conv_dims(layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 0))
    n_w = sum(o * c * k * k for o, c, k, _ in dims.values())
    n_bn = sum(o for o, _, _, bn in dims.values() if bn)
    n_b = sum(o for o, _, _, bn in dims.values() if not bn)
    uw = torch.rand(n_w, generator=gen, device=device) * 2.0 - 1.0
    ub = torch.rand(2 * n_bn + n_b, generator=gen, device=device)
    nb = torch.randn(2 * n_bn, generator=gen, device=device) * 0.05
    out: Dict[int, dict] = {}
    at_w = at_u = at_n = 0
    for i, (o, c, k, bn) in dims.items():
        bound = float(np.sqrt(1.0 / (c * k * k)))
        n = o * c * k * k
        entry = {"w": uw[at_w:at_w + n].view(o, c, k, k) * bound}
        at_w += n
        if bn:
            entry["bn_scale"] = 0.9 + 0.2 * ub[at_u:at_u + o]
            entry["var"] = 0.8 + 0.4 * ub[at_u + o:at_u + 2 * o]
            entry["bn_bias"] = nb[at_n:at_n + o]
            entry["mean"] = nb[at_n + o:at_n + 2 * o]
            at_u += 2 * o
            at_n += 2 * o
        else:
            entry["b"] = (ub[at_u:at_u + o] * 2.0 - 1.0) * bound
            at_u += o
        out[i] = entry
    return out


def fold(layers: List[dict], params: Dict[int, dict]) -> Dict[int, tuple]:
    """{conv index: (w OIHW f32, b f32)} with BN folded in float64."""
    out = {}
    for i, p in params.items():
        if "bn_scale" in p:
            scale = p["bn_scale"].double() / torch.sqrt(p["var"].double() + BN_EPS)
            w = p["w"].double() * scale[:, None, None, None]
            b = p["bn_bias"].double() - p["mean"].double() * scale
            out[i] = (w.float().contiguous(), b.float().contiguous())
        else:
            out[i] = (p["w"].float().contiguous(), p["b"].float().contiguous())
    return out


def sighted_folded(layers: List[dict], params: Dict[int, dict],
                   image: torch.Tensor) -> Dict[int, tuple]:
    """Folded weights of `params`, each conv's w and b scaled by the gain
    that gives its output unit RMS on `image` ((1, S, S, 3) f32 on the
    device), in one f32 pass (TF32 off), each layer's output scaled by its
    gain before the next reads it."""
    folded = fold(layers, params)
    out: Dict[int, tuple] = {}

    def conv(i, layer, h):
        w, b = folded[i]
        y = torch.nn.functional.conv2d(h, w, b, layer["stride"], ref._pad(layer))
        gain = 1.0 / float(y.square().mean().sqrt())
        out[i] = ((w * gain).contiguous(), (b * gain).contiguous())
        return ref.act(y * gain, layer["act"])

    with ref.exact_f32(), torch.no_grad():
        ref.walk(layers, image.permute(0, 3, 1, 2), conv)
    return out
