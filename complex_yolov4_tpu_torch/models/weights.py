"""Weight bridge between the JAX package's parameter trees and the port.

The JAX package keeps parameters as ``{"layer{i}": {"w": HWIO, "bn_scale",
"bn_bias"} | {"w", "b"}}`` and BatchNorm running statistics as ``{"layer{i}":
{"mean", "var"}}``. Here those trees arrive as numpy arrays (no JAX
import): `fold_batchnorm` folds BN into the conv exactly as
`complex_yolov4_tpu/models/network.py` `fold_batchnorm` does (float64 math,
float32 result), `from_folded` / `from_jax_params` turn the folded tree into
the port's module state, and `from_jax_quant` turns an int8 quant tree
into the int8 state. `init_params_np` makes seeded random parameters in the
same tree layout, so a run on a machine without JAX has weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import int8_conv
from .spec import ConvSpec, NetSpec

BN_EPS = 1e-5  # torch BatchNorm2d default, the JAX package's too


def fold_batchnorm(spec: NetSpec, params: Dict, state: Dict) -> Dict:
    """Fold BN running stats into conv weights: every conv gets ``{"w": HWIO
    f32, "b": f32}`` (y = scale*(conv(x)-mean)/sqrt(var+eps)+bias ==
    conv'(x)+b')."""
    folded = {}
    for i, layer in enumerate(spec.layers):
        key = f"layer{i}"
        if key not in params:
            continue
        p = params[key]
        if isinstance(layer, ConvSpec) and layer.batch_normalize:
            st = state[key]
            inv = 1.0 / np.sqrt(np.asarray(st["var"], np.float64) + BN_EPS)
            scale = np.asarray(p["bn_scale"], np.float64) * inv
            w = np.asarray(p["w"], np.float64) * scale[None, None, None, :]
            b = np.asarray(p["bn_bias"], np.float64) - np.asarray(st["mean"], np.float64) * scale
            folded[key] = {"w": w.astype(np.float32), "b": b.astype(np.float32)}
        else:
            folded[key] = {"w": np.asarray(p["w"], np.float32),
                           "b": np.asarray(p["b"], np.float32)}
    return folded


def from_folded(spec: NetSpec, folded: Dict) -> Dict[str, torch.Tensor]:
    """A BN-folded tree (numpy, ``{"layer{i}": {"w": HWIO, "b"}}``) -> the
    port's module state: ``{"layer{i}.weight": OIHW f32, "layer{i}.bias":
    f32}`` per conv (what `models.network.Darknet` takes)."""
    out: Dict[str, torch.Tensor] = {}
    for key, p in folded.items():
        w = np.asarray(p["w"], np.float32)
        out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[f"{key}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
    return out


def from_jax_params(spec: NetSpec, params_np: Dict, state_np: Dict
                    ) -> Dict[str, torch.Tensor]:
    """JAX param/state trees (numpy) -> the port's module state, BN folded
    (`from_folded` of `fold_batchnorm`)."""
    return from_folded(spec, fold_batchnorm(spec, params_np, state_np))


def from_jax_quant(spec: NetSpec, quant_np: Dict) -> Dict[str, torch.Tensor]:
    """The JAX quant tree (numpy, ``{"layer{i}": {"w_i8": HWIO int8,
    "w_scale", "b", "s_x"}}``, from `models.quantize.make_quant` of either
    package) -> `Darknet`'s int8 state: ``layer{i}.w_i8`` (C_out, k*k*C_in)
    int8 with columns in (ky, kx, ci) order, ``layer{i}.w_scale`` and
    ``layer{i}.b`` (C_out,) f32, ``layer{i}.s_x`` a float32 scalar."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(spec.layers):
        key = f"layer{i}"
        if key not in quant_np:
            continue
        if not isinstance(layer, ConvSpec):
            raise ValueError(f"{key} is not a conv")
        q = quant_np[key]
        w = np.asarray(q["w_i8"])
        if w.dtype != np.int8 or w.shape != (layer.size, layer.size, w.shape[2], layer.filters):
            raise ValueError(f"{key}: w_i8 must be HWIO int8, got {w.shape} {w.dtype}")
        out[f"{key}.w_i8"] = int8_conv.pack_weight(torch.from_numpy(np.array(w)))
        out[f"{key}.w_scale"] = torch.from_numpy(np.array(q["w_scale"], np.float32))
        out[f"{key}.b"] = torch.from_numpy(np.array(q["b"], np.float32))
        out[f"{key}.s_x"] = torch.tensor(np.float32(q["s_x"]), dtype=torch.float32)
    return out


def init_params_np(spec: NetSpec, seed: int) -> Tuple[Dict, Dict]:
    """Seeded random (params, state) in the JAX tree layout, numpy f32.

    Conv weights are uniform in +-sqrt(1/fan_in) (the JAX package's init);
    BN scale, bias and running statistics are non-trivial, so the fold is
    exercised."""
    rng = np.random.default_rng(seed)
    params: Dict = {}
    state: Dict = {}
    chans = (spec.in_channels,) + spec.out_channels()
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, ConvSpec):
            continue
        cin, cout, k = chans[i], layer.filters, layer.size
        bound = float(np.sqrt(1.0 / (cin * k * k)))
        entry = {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)}
        if layer.batch_normalize:
            entry["bn_scale"] = rng.uniform(0.9, 1.1, cout).astype(np.float32)
            entry["bn_bias"] = rng.normal(0.0, 0.05, cout).astype(np.float32)
            state[f"layer{i}"] = {
                "mean": rng.normal(0.0, 0.05, cout).astype(np.float32),
                "var": rng.uniform(0.8, 1.2, cout).astype(np.float32),
            }
        else:
            entry["b"] = rng.uniform(-bound, bound, cout).astype(np.float32)
        params[f"layer{i}"] = entry
    return params, state
