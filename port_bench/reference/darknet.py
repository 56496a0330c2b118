"""Plain forward of a darknet layer list in float32, with the served
precisions emulated layer by layer.

The layer list is the configuration file's: dicts of type conv (filters,
size, stride, pad, bn, act), maxpool, route, shortcut, upsample, yolo.
Weights are BN-folded, OIHW f32 (`frozen.weights`). Each conv runs in one
of these modes, chosen per layer by the caller:
- "f32": the conv, bias and activation in the served compute dtype (the
  served bf16 epilogue, `Reference`), or in float32 (TF32 off on a card);
- "int8": the served int8 PTQ arithmetic: the input quantized with its
  calibrated scale s_x (clip(round(x / s_x), +-127)), the weight per output
  channel (s_w = max|w| / 127), the integer sum, then sum * s_x * s_w + b
  and the activation in f32. The sum is taken by an f32 conv of integer
  values, exact to f32 rounding (about 6e-8 of it);
- the control's lower precisions: "fp8" (inputs per tensor and weights per
  output channel scaled to e4m3's 448 and rounded to float8_e4m3fn) and
  "int4" (the int8 arithmetic with 7 levels in place of 127).
Decode is the Complex-YOLO head decode in f32 (sigmoid x, y, conf and
classes; exp(w, l) clamped at 1e3 times the anchor; raw im, re; the grid
offsets; boxes flattened in (gy, gx, anchor) order), as the cfg's
reference implementation defines it (`scale_x_y` not applied).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

EXP_CLAMP_MAX = 1e3
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation in x's dtype; mish in its single-exp form x * q /
    (q + 2), q = s^2 + 2s, s = exp(min(x, 20)), the served executor's (in
    bf16 each op rounds as the served path's do)."""
    if kind == "mish":
        s = torch.exp(torch.clamp(x, max=20.0))
        q = s * s + 2.0 * s
        return torch.where(x > 20.0, x, x * q / (q + 2.0))
    if kind == "leaky":
        return F.leaky_relu(x, 0.1)
    if kind == "relu":
        return F.relu(x)
    if kind == "linear":
        return x
    raise ValueError(f"unknown activation {kind!r}")


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if stride == size:
        return F.max_pool2d(x, size, stride)
    if stride == 1 and size % 2 == 1:
        return F.max_pool2d(x, size, 1, padding=size // 2)
    p = size // 2

    def pads(dim: int):
        lo = (size - 1) // 2
        hi = lo + 1 if ((dim - 1) // stride) != ((dim + 2 * p - size) // stride) else lo
        return lo, hi

    (t, b), (l, r) = pads(x.shape[2]), pads(x.shape[3])
    return F.max_pool2d(F.pad(x, (l, r, t, b), mode="replicate"), size, stride)


def other_layer(layer: dict, h: torch.Tensor, outputs: List[Optional[torch.Tensor]],
                i: int) -> torch.Tensor:
    kind = layer["type"]
    if kind == "maxpool":
        return _maxpool(h, layer["size"], layer["stride"])
    if kind == "upsample":
        return F.interpolate(h, scale_factor=layer["stride"], mode="nearest")
    if kind == "route":
        src = layer["layers"]
        if len(src) == 1:
            x = outputs[src[0]]
            c = x.shape[1] // layer["groups"]
            return x[:, layer["group_id"] * c:(layer["group_id"] + 1) * c]
        return torch.cat([outputs[j] for j in src], dim=1)
    if kind == "shortcut":
        return act(outputs[layer["from"]] + outputs[i - 1], layer["act"])
    raise ValueError(f"unsupported layer {layer!r}")


def last_use(layers: List[dict]) -> List[int]:
    last = list(range(len(layers)))
    for i, layer in enumerate(layers):
        srcs = list(layer["layers"]) if layer["type"] == "route" else []
        if layer["type"] == "shortcut":
            srcs.append(layer["from"])
        if i > 0 and layer["type"] != "route":
            srcs.append(i - 1)
        for j in srcs:
            last[j] = max(last[j], i)
    return last


ConvFn = Callable[[int, dict, torch.Tensor], torch.Tensor]


def walk(layers: List[dict], x: torch.Tensor, conv: ConvFn,
         stop_after: Optional[int] = None) -> List[torch.Tensor]:
    """x (B, C, S, S) -> the raw head inputs (B, A*(7+C), G, G), one per
    yolo layer, or [the activation of `stop_after`]. `conv(i, layer, h)`
    computes conv i; outputs are freed after their last reader."""
    last = last_use(layers)
    outputs: List[Optional[torch.Tensor]] = []
    heads = []
    h = x
    for i, layer in enumerate(layers):
        if layer["type"] == "conv":
            h = conv(i, layer, h)
        elif layer["type"] == "yolo":
            heads.append(outputs[i - 1])
            h = outputs[i - 1]
        else:
            h = other_layer(layer, h, outputs, i)
        if stop_after is not None and i >= stop_after:
            return [h]
        outputs.append(h)
        for j in range(i + 1):
            if outputs[j] is not None and last[j] <= i:
                outputs[j] = None
    return heads


def _pad(layer: dict) -> int:
    return (layer["size"] - 1) // 2 if layer["pad"] else 0


def quantize_weight(w: torch.Tensor, levels: int):
    """OIHW f32 -> (integer-valued f32 weight, per-output-channel f32 scale)."""
    s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / levels
    q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -levels, levels)
    return q, s_w


def _fp8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def chain(layers: List[dict], quantized) -> set:
    """Convs i whose output goes on in the int8 domain: conv i and i+1 both
    quantized and i+1 the only reader of i. Their epilogue requantizes the
    f32 result for i+1 with no rounding to the compute dtype between."""
    q = set(quantized)
    readers: Dict[int, set] = {i: set() for i in range(len(layers))}
    for j, layer in enumerate(layers):
        if layer["type"] == "route":
            for src in layer["layers"]:
                readers[src].add(j)
            continue
        if layer["type"] == "shortcut":
            readers[layer["from"]].add(j)
        if j > 0:
            readers[j - 1].add(j)
    return {i for i in q if i + 1 in q and readers[i] == {i + 1}}


class Reference:
    """The plain network of one configuration on one device.

    weights: {conv index: (w OIHW f32, b f32)} on the device; modes:
    {conv index: "f32" | "int8" | "fp8" | "int4"} (missing: "f32");
    act_max: {conv index: calibrated max |input|}, for the int modes;
    act_dtype: the served compute dtype. With bfloat16, the served bf16
    arithmetic in plain ops: activations are bf16 tensors; a conv takes
    its input and weight in bf16, its f32 sum rounds to bf16, and the bias
    and the activation run in bf16 (the served executor's epilogue); an
    int8 conv quantizes its bf16 input, and its f32 epilogue (scales, bias,
    activation) rounds to bf16, or, where it hands its result to the next
    int8 conv (`chain`), stays f32 for that conv to quantize. The hand
    kernels' own epilogues (f32 bias and activation, fused stages) round
    otherwise on a few layers; the cells' limits hold that difference as
    part of the floor. In float32 no rounding."""

    def __init__(self, layers: List[dict], weights: Dict[int, tuple],
                 modes: Optional[Dict[int, str]] = None,
                 act_max: Optional[Dict[int, float]] = None,
                 act_dtype: torch.dtype = torch.float32):
        self.layers = layers
        self.modes = dict(modes or {})
        self.act_max = dict(act_max or {})
        self.act_dtype = act_dtype
        self.weights = {i: (w.to(act_dtype), b) for i, (w, b) in weights.items()}
        self.chain = chain(layers, [i for i, m in self.modes.items() if m in ("int8", "int4")])
        self._int: Dict[int, tuple] = {}
        for i, mode in self.modes.items():
            if mode in ("int8", "int4"):
                levels = 127 if mode == "int8" else 7
                q, s_w = quantize_weight(weights[i][0].float(), levels)
                s_x = torch.tensor(max(self.act_max[i], 1e-12) / levels, dtype=torch.float32)
                self._int[i] = (q, s_w, float(s_x), float(torch.tensor(1.0) / s_x), levels)

    def conv(self, i: int, layer: dict, h: torch.Tensor) -> torch.Tensor:
        w, b = self.weights[i]
        mode = self.modes.get(i, "f32")
        stride, pad = layer["stride"], _pad(layer)
        dt = self.act_dtype
        if mode == "f32":
            y = F.conv2d(h.to(dt), w, None, stride, pad)
            return act(y + b.to(dt)[None, :, None, None], layer["act"])
        if mode == "fp8":
            x = h.float()
            sx = torch.clamp(x.abs().amax(), min=1e-12) / FP8_MAX
            wf = w.float()
            sw = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12)[:, None, None, None] / FP8_MAX
            y = F.conv2d(_fp8(x, sx), _fp8(wf, sw), None, stride, pad).to(dt)
            return act(y + b.to(dt)[None, :, None, None], layer["act"])
        q, s_w, s_x, inv_s_x, levels = self._int[i]
        xq = torch.clamp(torch.round(h.float() * inv_s_x), -levels, levels)
        acc = F.conv2d(xq, q, None, stride, pad)
        y = act(acc * (s_x * s_w)[None, :, None, None] + b[None, :, None, None], layer["act"])
        return y if i in self.chain else y.to(dt)

    def heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        with exact_f32(), torch.no_grad():
            return walk(self.layers, x, self.conv)

    def decoded(self, x: torch.Tensor, img_size: int) -> torch.Tensor:
        """(B, S, S, 3) f32 raster -> decoded (B, N, 7+C) f32, resized to
        `img_size` first where S differs."""
        raw = self.heads(resize(x, img_size).permute(0, 3, 1, 2))
        yolos = [layer for layer in self.layers if layer["type"] == "yolo"]
        return torch.cat([decode(r, y, img_size) for r, y in zip(raw, yolos)], dim=1)


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, S, S, C) -> (B, size, size, C): half-pixel bilinear without
    antialiasing, the served resize of a 608 raster to another input size."""
    if images.shape[1] == size:
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).contiguous()


def calibrate(layers: List[dict], weights: Dict[int, tuple], images: torch.Tensor,
              convs: List[int], act_dtype: torch.dtype = torch.float32) -> Dict[int, float]:
    """max |input| of each conv in `convs` over (B, S, S, 3) rasters, the
    network without int8 in `act_dtype` (the served PTQ calibration)."""
    seen: Dict[int, float] = {}
    ref = Reference(layers, weights, act_dtype=act_dtype)
    wanted = set(convs)

    def conv(i, layer, h):
        if i in wanted:
            seen[i] = max(seen.get(i, 0.0), float(h.float().abs().amax()))
        return ref.conv(i, layer, h)

    with exact_f32(), torch.no_grad():
        walk(layers, images.permute(0, 3, 1, 2), conv)
    return seen


def decode(feat: torch.Tensor, yolo: dict, img_size: int) -> torch.Tensor:
    """(B, A*(7+C), G, G) raw head -> (B, G*G*A, 7+C) rows [x, y, w, l, im,
    re, conf, cls...] in input pixels."""
    feat = feat.float()
    b, _, g, _ = feat.shape
    anchors = torch.tensor(yolo["anchors"], dtype=torch.float32, device=feat.device)
    na, nc = anchors.shape[0], yolo["num_classes"]
    stride = img_size / g
    p = feat.permute(0, 2, 3, 1).reshape(b, g, g, na, 7 + nc)
    grid = torch.arange(g, dtype=torch.float32, device=feat.device)
    bx = torch.sigmoid(p[..., 0]) + grid.view(1, 1, g, 1)
    by = torch.sigmoid(p[..., 1]) + grid.view(1, g, 1, 1)
    bw = torch.clamp(torch.exp(p[..., 2]), max=EXP_CLAMP_MAX) * (anchors[:, 0] / stride)
    bl = torch.clamp(torch.exp(p[..., 3]), max=EXP_CLAMP_MAX) * (anchors[:, 1] / stride)
    rows = torch.cat([torch.stack([bx, by, bw, bl], -1) * stride, p[..., 4:6],
                      torch.sigmoid(p[..., 6:7]), torch.sigmoid(p[..., 7:])], dim=-1)
    return rows.reshape(b, -1, 7 + nc)
