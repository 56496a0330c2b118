"""Inference executor for the darknet layer IR, in PyTorch.

Counterpart of the inference branch of `complex_yolov4_tpu/models/network.py`
`apply` with BN folded (`weights.from_jax_params`), with its stem and fused
3x3 kernels switched on:

- conv + folded bias + mish/leaky/relu/linear. Outside the kernels this
  follows the JAX inference epilogue: the conv output is cast to the
  compute dtype, then bias and activation run in that dtype;
- the three darknet maxpool variants (plain, SAME with -inf for the SPP
  pools, and the replicate-padded MaxPoolDark);
- route (concat), CSP group route, shortcut, nearest upsample, yolo heads.

Activations are NCHW tensors held in `torch.channels_last` memory format,
so `x.permute(0, 2, 3, 1)` is a free, contiguous NHWC view for the kernels,
whose public functions keep the JAX layouts.

Kernel routing (bf16 compute only), mirroring the JAX executor, in this
order of precedence:
- `ops.fused_stage` (``fused_stages=True``) takes each segment that
  `plan_segments` finds, on square inputs, without calibration capture, and
  only when none of its convs is quantized (`network.py:313-321`);
- `ops.int8_conv` takes every conv in ``quant`` (the int8 branch,
  `network.py:456-501`); a conv in `quantize.chain_set` hands its consumer
  an int8 tensor, every other quantized conv quantizes its bf16 input with
  a plain elementwise pass;
- `ops.stem_conv` takes a 3x3, stride-1, padded conv with C_in <= 14 on the
  f32 raster (layer 0);
- `ops.conv3x3` takes a 3x3 padded conv at stride 1 or 2 with C_in <= 128,
  C_out <= 128 and W_out >= 128.
At 608 that routes complex_yolov4's layer 0 to the stem kernel and layers 1,
6, 11, 16 and 19 to the 3x3 kernel; with fused stages, layers 2-10 and 12-23
go to two fused-stage launches and only layers 1 and 11 stay on the 3x3
kernel; with int8 by `quantize.default_skip`, 68 convs go to the int8
kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv3x3_mod
from ..ops import fused_stage as fused_mod
from ..ops import int8_conv as int8_mod
from ..ops import stem_conv as stem_mod
from ..ops.activations import act
from .quantize import chain_set
from .spec import ConvSpec, MaxPoolSpec, NetSpec, RouteSpec, ShortcutSpec, UpsampleSpec, YoloSpec
from .yolo_head import decode_head


def kernel_routes(spec: NetSpec, img_size: int) -> Dict[int, str]:
    """{layer index: "stem" | "conv3x3"} for the convs the kernels take on a
    square `img_size` input (pure Python, no compute)."""
    chans = (spec.in_channels,) + spec.out_channels()
    strides = spec.out_strides()
    routes: Dict[int, str] = {}
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, ConvSpec) or layer.size != 3 or not layer.pad:
            continue
        size_in = img_size // (strides[i - 1] if i else 1)
        if i == 0 and stem_mod.shape_ok(chans[0], layer.filters, 3, layer.stride):
            routes[i] = "stem"  # only layer 0 reads the f32 raster
        elif conv3x3_mod.shape_ok(size_in, size_in, chans[i], layer.filters, 3,
                                  layer.stride):
            routes[i] = "conv3x3"
    return routes


def _kernel_capable(spec: NetSpec, i: int, layer: ConvSpec, c_in: int) -> bool:
    """Whether conv `i` can take a kernel at some input size (its packed
    weight is then kept as a buffer)."""
    if layer.size != 3 or not layer.pad:
        return False
    if i == 0 and stem_mod.shape_ok(c_in, layer.filters, 3, layer.stride):
        return True
    return conv3x3_mod.channels_ok(c_in, layer.filters, 3, layer.stride)


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Darknet maxpool variants (reference: src/models/darknet2pytorch.py:31-61)."""
    if stride == size:
        return F.max_pool2d(x, size, stride)
    if stride == 1 and size % 2 == 1:
        return F.max_pool2d(x, size, 1, padding=size // 2)  # -inf padding
    # MaxPoolDark: replicate padding so out = (in + (size-1) - size)//stride + 1
    p = size // 2

    def pads(dim: int):
        lo = (size - 1) // 2
        hi = lo + 1 if ((dim - 1) // stride) != ((dim + 2 * p - size) // stride) else lo
        return lo, hi

    (t, bm), (l, r) = pads(x.shape[2]), pads(x.shape[3])
    x = F.pad(x, (l, r, t, bm), mode="replicate")
    return F.max_pool2d(x, size, stride)


class Darknet(nn.Module):
    """Folded-BN inference network over a `NetSpec`.

    Args:
      spec: the (unfolded) layer IR; BN is already folded into `state`.
      state: ``{"layer{i}.weight": OIHW, "layer{i}.bias": (C_out,)}`` from
        `weights.from_jax_params`.
      compute_dtype: torch.bfloat16 (kernels on) or torch.float32.
      device: where the weights live; inputs must be on it too.
      quant: int8 state from `weights.from_jax_quant` (bf16 only): the convs
        it holds run on the int8 kernel.
      fused_stages: run the planned CSP segments on the fused-stage kernel
        (bf16 only).

    Buffers: per conv ``w{i}``/``b{i}`` in the compute dtype; in bf16 also
    ``bk{i}``, the f32 bias, and for convs a 3x3 kernel can take ``wk{i}``,
    the weight packed once to (9*C_in, C_out) bf16; per quantized conv
    ``wq{i}`` (C_out, k*k*C_in) int8, ``wqs{i}`` and ``bq{i}`` f32.
    """

    def __init__(self, spec: NetSpec, state: Dict[str, torch.Tensor], *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device, quant: Optional[Dict[str, torch.Tensor]] = None,
                 fused_stages: bool = False):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bf16 or f32, got {compute_dtype}")
        bf16 = compute_dtype == torch.bfloat16
        if (quant or fused_stages) and not bf16:
            raise ValueError("int8 and fused stages run in bf16 compute only")
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.fused_stages = fused_stages
        chans = (spec.in_channels,) + spec.out_channels()
        for i, layer in enumerate(spec.layers):
            if not isinstance(layer, ConvSpec):
                continue
            w = state[f"layer{i}.weight"].float()
            b = state[f"layer{i}.bias"].float()
            self.register_buffer(f"w{i}", w.to(device, compute_dtype).contiguous(
                memory_format=torch.channels_last))
            self.register_buffer(f"b{i}", b.to(device, compute_dtype))
            if bf16:
                self.register_buffer(f"bk{i}", b.to(device))
                if _kernel_capable(spec, i, layer, chans[i]):
                    self.register_buffer(f"wk{i}", conv3x3_mod.pack_weight(w).to(device))
        # int8 convs: {layer index: (s_x, float32 1/s_x)}
        self._quant: Dict[int, tuple] = {}
        for key in sorted({k.split(".")[0] for k in (quant or {})}):
            i = int(key[len("layer"):])
            self.register_buffer(f"wq{i}", quant[f"{key}.w_i8"].to(device).contiguous())
            self.register_buffer(f"wqs{i}", quant[f"{key}.w_scale"].float().to(device))
            self.register_buffer(f"bq{i}", quant[f"{key}.b"].float().to(device))
            s_x = np.float32(quant[f"{key}.s_x"].item())
            self._quant[i] = (float(s_x), float(np.float32(1.0) / s_x))
        self._chain = chain_set(spec, [f"layer{i}" for i in self._quant])
        # liveness: the last layer that reads each output
        self._last_use = list(range(len(spec.layers)))
        for i, layer in enumerate(spec.layers):
            srcs = []
            if isinstance(layer, RouteSpec):
                srcs = list(layer.layers)
            elif isinstance(layer, ShortcutSpec):
                srcs = [layer.from_index]
            if i > 0 and not isinstance(layer, RouteSpec):
                srcs.append(i - 1)
            for j in srcs:
                self._last_use[j] = max(self._last_use[j], i)
        self._routes: Dict[tuple, Dict[int, str]] = {}
        self._segments: Dict[int, Dict[int, tuple]] = {}

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def segments(self, img_size: int) -> Dict[int, tuple]:
        """{start layer: (Segment, SegmentWeights)} of the fused segments at a
        square `img_size` ({} unless fused_stages); a segment that holds a
        quantized conv stays unfused."""
        if not self.fused_stages:
            return {}
        if img_size not in self._segments:
            view = {}
            for i, layer in enumerate(self.spec.layers):
                if isinstance(layer, ConvSpec):
                    view[f"layer{i}.weight"] = getattr(self, f"w{i}")
                    view[f"layer{i}.bias"] = getattr(self, f"bk{i}")
            self._segments[img_size] = {
                seg.start: (seg, fused_mod.segment_weights(seg, view))
                for seg in fused_mod.plan_segments(self.spec, img_size)
                if not any(o.layer_index in self._quant for o in seg.ops)}
        return self._segments[img_size]

    def routes(self, img_size: int, fused: bool = True) -> Dict[int, str]:
        """Kernel routes of a square `img_size` input ({} in f32 compute):
        {layer index: "stem" | "conv3x3" | "int8" | "fused_stage s-e"}, every
        layer of a fused segment s..e included; fused=False: as when the
        segments are off for a call (calibration capture)."""
        if self.compute_dtype != torch.bfloat16:
            return {}
        key = (img_size, fused)
        if key not in self._routes:
            routes = {i: r for i, r in kernel_routes(self.spec, img_size).items()
                      if i not in self._quant}
            routes.update({i: "int8" for i in self._quant})
            for start, (seg, _) in (self.segments(img_size) if fused else {}).items():
                routes.update({i: f"fused_stage {start}-{seg.end}"
                               for i in range(start, seg.end + 1)})
            self._routes[key] = dict(sorted(routes.items()))
        return self._routes[key]

    def _int8_conv(self, i: int, layer: ConvSpec, h: torch.Tensor,
                   kernels: bool) -> torch.Tensor:
        s_x, inv_s_x = self._quant[i]
        x = h.permute(0, 2, 3, 1)
        if h.dtype != torch.int8:  # a chained producer already requantized
            x = int8_mod.quantize_input(x, inv_s_x)
        x = x.contiguous()
        kw = {"ksize": layer.size, "stride": layer.stride, "s_x": s_x,
              "activation": layer.activation}
        if i in self._chain:
            kw.update(out="int8", inv_s_next=self._quant[i + 1][1])
        fn = int8_mod.int8_conv if kernels else int8_mod.int8_conv_plain
        y = fn(x, getattr(self, f"wq{i}"), getattr(self, f"wqs{i}"),
               getattr(self, f"bq{i}"), **kw)
        return y.permute(0, 3, 1, 2)

    def _conv(self, i: int, layer: ConvSpec, h: torch.Tensor, route: Optional[str],
              kernels: bool) -> torch.Tensor:
        cd = self.compute_dtype
        if route == "int8":
            return self._int8_conv(i, layer, h, kernels)
        if route is not None:
            wk, bk = getattr(self, f"wk{i}"), getattr(self, f"bk{i}")
            if route == "stem":
                x = h.float().permute(0, 2, 3, 1).contiguous()
                fn = stem_mod.conv3x3_stem if kernels else stem_mod.stem_plain
                y = fn(x, wk, bk, activation=layer.activation)
            else:
                x = h.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
                fn = conv3x3_mod.conv3x3_fused if kernels else conv3x3_mod.conv3x3_plain
                y = fn(x, wk, bk, stride=layer.stride, activation=layer.activation)
            return y.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        pad = (layer.size - 1) // 2 if layer.pad else 0
        y = F.conv2d(h.to(cd), getattr(self, f"w{i}"), None, layer.stride, pad)
        y = y + getattr(self, f"b{i}")[None, :, None, None]
        return act(y, layer.activation).to(cd)

    def forward(self, x: torch.Tensor, *, kernels: bool = True,
                stop_after: Optional[int] = None,
                capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B, C, S, S) f32 raster (NCHW, channels_last memory) ->
        decoded (B, num_boxes, 7+C) f32.

        kernels=False runs the routed layers through the kernels' plain
        versions instead (the on-card reference). stop_after: return the
        activation of that layer instead (NCHW), for tests. capture: a dict
        that receives {layer_key: max |conv input|} (f32 scalar tensors) for
        every conv, for int8 calibration; it turns fused segments off."""
        img_size = x.shape[-1]
        segments = {}
        if capture is None and x.shape[-1] == x.shape[-2]:
            segments = self.segments(img_size)
        routes = self.routes(img_size, fused=bool(segments))
        outputs: List[Optional[torch.Tensor]] = []
        decoded = []
        h = x
        skip_until = -1
        for i, layer in enumerate(self.spec.layers):
            if i <= skip_until:
                continue  # inside a fused segment; its outputs are appended
            if i in segments:
                seg, sw = segments[i]
                xs = h.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
                fn = fused_mod.apply_segment if kernels else fused_mod.fused_stage_plain
                h = fn(seg, xs, sw).permute(0, 3, 1, 2)
                outputs.extend([None] * (seg.end - seg.start))
                skip_until = seg.end
                i = seg.end
            elif isinstance(layer, ConvSpec):
                if capture is not None:
                    m = h.float().abs().amax()
                    if h.dtype == torch.int8:  # chained input: the dequant domain
                        m = m * torch.tensor(self._quant[i][0], dtype=torch.float32)
                    capture[f"layer{i}"] = m
                h = self._conv(i, layer, h, routes.get(i), kernels)
            elif isinstance(layer, MaxPoolSpec):
                h = _maxpool(h, layer.size, layer.stride)
            elif isinstance(layer, UpsampleSpec):
                h = F.interpolate(h, scale_factor=layer.stride, mode="nearest")
            elif isinstance(layer, RouteSpec):
                if len(layer.layers) == 1:
                    src = outputs[layer.layers[0]]
                    c = src.shape[1] // layer.groups
                    h = src[:, layer.group_id * c:(layer.group_id + 1) * c]
                else:
                    h = torch.cat([outputs[j] for j in layer.layers], dim=1)
            elif isinstance(layer, ShortcutSpec):
                h = act(outputs[layer.from_index] + outputs[i - 1], layer.activation)
            elif isinstance(layer, YoloSpec):
                decoded.append(decode_head(outputs[i - 1], layer, img_size))
                h = outputs[i - 1]
            if stop_after is not None and i >= stop_after:
                return h
            outputs.append(h)
            for j in range(i + 1):
                if outputs[j] is not None and self._last_use[j] <= i:
                    outputs[j] = None
        return torch.cat(decoded, dim=1)
