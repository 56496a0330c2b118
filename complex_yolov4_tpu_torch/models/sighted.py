"""Weights that whole-network checks can see through (`sighted_params_np`),
made from the numpy trees of `weights.init_params_np`."""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.activations import act
from .network import _other_layer, precision_scope
from .spec import ConvSpec, NetSpec, YoloSpec
from .weights import fold_batchnorm


def sighted_params_np(spec: NetSpec, params: Dict, state: Dict, image: np.ndarray,
                      device="cpu") -> Tuple[Dict, Dict]:
    """(params, state) of `init_params_np` -> the same trees with every conv
    rescaled so that its BN-folded output, before the activation, has unit
    RMS on `image` ((B, H, W, C_in) f32, NHWC).

    With `init_params_np`'s weights each conv shrinks its input about 3x
    against the folded biases, so the input's share of the heads decays
    with depth (about 10x every 15 layers of complex_yolov4) and a
    whole-network check cannot see the early layers. Rescaled layer by
    layer on one image, every layer carries the input on: the result does
    not depend on depth, unlike one gain for all layers.

    The gain g of conv i multiplies its ``bn_scale`` and ``bn_bias`` (with
    BN) or its ``w`` and ``b`` (without), which scales the folded weight and
    bias both by g; ``state`` is returned as it came. One f32 pass on
    `device` (TF32 off) over `image`, each layer's output scaled by its
    gain before the next reads it. Pure numpy trees in and out: the JAX
    package and the port get the same arrays."""
    device = torch.device(device)
    params = copy.deepcopy(params)
    folded = fold_batchnorm(spec, params, state)
    h = torch.from_numpy(np.ascontiguousarray(image, np.float32)).permute(0, 3, 1, 2).to(device)
    outputs = []
    with torch.no_grad(), precision_scope(torch.float32, device):
        for i, layer in enumerate(spec.layers):
            if isinstance(layer, ConvSpec):
                key = f"layer{i}"
                w = torch.from_numpy(folded[key]["w"].transpose(3, 2, 0, 1).copy()).to(device)
                b = torch.from_numpy(folded[key]["b"]).to(device)
                pad = (layer.size - 1) // 2 if layer.pad else 0
                y = F.conv2d(h, w, b, layer.stride, pad)
                gain = np.float32(1.0 / float(y.square().mean().sqrt()))
                names = ("bn_scale", "bn_bias") if layer.batch_normalize else ("w", "b")
                for name in names:
                    params[key][name] = (params[key][name] * gain).astype(np.float32)
                h = act(y * float(gain), layer.activation)
            elif isinstance(layer, YoloSpec):
                h = outputs[i - 1]
            else:
                h = _other_layer(layer, h, outputs, i)
            outputs.append(h)
    return params, state
