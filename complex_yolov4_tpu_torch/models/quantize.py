"""Post-training int8 quantization of the serving convs.

Counterpart of `complex_yolov4_tpu/models/quantize.py`, under the same
names. Symmetric PTQ:
- weights: per output channel, s_w = max(maxabs, 1e-12) / 127, w_i8 =
  clip(rint(w / s_w), -127, 127), from BN-folded HWIO weights (numpy,
  bit-identical to the JAX package);
- activations: per conv input, s_x = max(calibrated maxabs, 1e-12) / 127,
  kept as a float32 value;
- `default_skip` keeps in bf16 every conv with C_in < 256 and the convs
  that feed a YOLO head (68 of complex_yolov4's 110 convs are quantized);
- `chain_set`: where conv i+1 is the sole reader of quantized conv i and
  both are quantized, conv i's epilogue requantizes straight to conv
  i+1's int8 domain.

The quant tree is the JAX package's layout as numpy, ``{"layer{i}":
{"w_i8": HWIO int8, "w_scale": (C_out,) f32, "b": (C_out,) f32, "s_x":
float32}}``; `weights.from_jax_quant` turns it into `Darknet`'s buffers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Set

import numpy as np
import torch

from .spec import ConvSpec, NetSpec, RouteSpec, ShortcutSpec, YoloSpec


def consumers(spec: NetSpec) -> Dict[int, Set[int]]:
    """Layer index -> set of layer indices that read its output tensor."""
    out: Dict[int, Set[int]] = {i: set() for i in range(len(spec.layers))}
    for j, layer in enumerate(spec.layers):
        if isinstance(layer, RouteSpec):
            for s in layer.layers:
                out[s].add(j)
            continue
        if isinstance(layer, ShortcutSpec):
            out[layer.from_index].add(j)
        if j > 0:
            out[j - 1].add(j)
    return out


def chain_set(spec: NetSpec, quant_keys) -> Set[int]:
    """Indices i whose output can stay int8: conv i and conv i+1 are both
    quantized and i+1 is the sole reader of i's output."""
    keys = set(quant_keys)
    cons = consumers(spec)
    out: Set[int] = set()
    for i, layer in enumerate(spec.layers[:-1]):
        if (isinstance(layer, ConvSpec)
                and isinstance(spec.layers[i + 1], ConvSpec)
                and f"layer{i}" in keys and f"layer{i + 1}" in keys
                and cons[i] == {i + 1}):
            out.add(i)
    return out


def head_conv_indices(spec: NetSpec) -> Set[int]:
    """Indices of convs feeding a YOLO head directly."""
    return {i - 1 for i, layer in enumerate(spec.layers)
            if isinstance(layer, YoloSpec) and i > 0}


def default_skip(spec: NetSpec) -> Set[int]:
    """Convs kept in bf16 by default: layer 0, every conv with C_in < 256,
    and the head convs."""
    chans = (spec.in_channels,) + spec.out_channels()
    skip = {0} | head_conv_indices(spec)
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, ConvSpec) and chans[i] < 256:
            skip.add(i)
    return skip


def quantize_weights(spec: NetSpec, folded_params: Dict,
                     skip: Optional[Set[int]] = None) -> Dict:
    """BN-folded params (numpy, ``{"layer{i}": {"w": HWIO, "b"}}``) ->
    per-layer ``{"w_i8", "w_scale", "b"}``. Layers in `skip` (default
    `default_skip`) are omitted."""
    if skip is None:
        skip = default_skip(spec)
    out: Dict = {}
    for i, layer in enumerate(spec.layers):
        key = f"layer{i}"
        if not isinstance(layer, ConvSpec) or i in skip or key not in folded_params:
            continue
        p = folded_params[key]
        if "b" not in p:
            raise ValueError(f"{key}: quantize_weights needs BN-folded params (fold_batchnorm)")
        w = np.asarray(p["w"], np.float32)
        s_w = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0), 1e-12) / 127.0
        w_i8 = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
        out[key] = {"w_i8": w_i8, "w_scale": np.asarray(s_w, np.float32),
                    "b": np.asarray(p["b"], np.float32)}
    return out


def calibrate(spec: NetSpec, folded_params: Dict, batches: Iterable[np.ndarray], *,
              device: torch.device) -> Dict[str, float]:
    """Run the bf16 network (no int8, no fused segments) over calibration
    batches of (B, H, W, 3) f32 rasters and record the running max |conv
    input| per conv. Returns {layer_key: max_abs}."""
    from . import weights
    from .network import Darknet

    model = Darknet(spec, weights.from_folded(spec, folded_params),
                    compute_dtype=torch.bfloat16, device=device)
    acc: Dict[str, float] = {}
    with torch.inference_mode():
        for batch in batches:
            x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
            maxes: Dict[str, torch.Tensor] = {}
            model(x.permute(0, 3, 1, 2), capture=maxes)
            for k, v in maxes.items():
                acc[k] = max(acc.get(k, 0.0), float(v))
    return acc


def make_quant(spec: NetSpec, folded_params: Dict, act_max: Dict[str, float], *,
               skip: Optional[Set[int]] = None) -> Dict:
    """The quant tree ``{layer_key: {w_i8, w_scale, b, s_x}}``."""
    out: Dict = {}
    for key, entry in quantize_weights(spec, folded_params, skip).items():
        if key not in act_max:
            continue
        s_x = max(float(act_max[key]), 1e-12) / 127.0
        out[key] = dict(entry, s_x=np.float32(s_x))
    return out


def quantize_model(spec: NetSpec, folded_params: Dict, batches: Sequence[np.ndarray], *,
                   device: torch.device, skip: Optional[Set[int]] = None) -> Dict:
    """One-call PTQ: calibrate + quantize. `batches` are (B, H, W, 3) BEV
    rasters."""
    act_max = calibrate(spec, folded_params, batches, device=device)
    return make_quant(spec, folded_params, act_max, skip=skip)
