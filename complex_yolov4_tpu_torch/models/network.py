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

Kernel routing, mirroring the JAX executor, in this order of precedence:
- `ops.fused_stage` (``fused_stages=True``) takes each segment that
  `plan_segments` finds, on square inputs, without calibration capture, and
  only when none of its convs is quantized (`network.py:313-321`);
- `ops.int8_conv` takes every conv in ``quant`` (the int8 branch,
  `network.py:456-501`); a conv in `quantize.chain_set` hands its consumer
  an int8 tensor, every other quantized conv hands the kernel its bf16
  input, which the kernel quantizes as it loads it;
- `ops.stem_conv` takes a 3x3, stride-1, padded conv with C_in <= 14 on the
  f32 raster (layer 0), in bf16 compute only: the JAX executor takes its
  stem only then (`network.py:502-513`), so f32 runs layer 0 on cuDNN;
- `ops.conv3x3` takes a 3x3 padded conv at stride 1 or 2 with C_in <= 128,
  C_out <= 128 and W_out >= 128: in bf16 on any device, in f32 on CUDA
  only (its f32 instance takes and gives f32). The JAX executor runs its
  Pallas conv only on an accelerator (`_use_pallas_default`), so an f32
  model on the CPU convolves in full f32, as XLA does there.
The stem, 3x3 and fused-stage kernels are reached only through their
`torch.library` custom ops (``cyv4::stem_conv3x3``, ``cyv4::conv3x3``,
``cyv4::fused_stage``, called by the wrappers), one path for eager calls
and for `torch.export` (`cli.export`), which traces a bf16 forward without
a host read; the int8 conv is a plain wrapper (no export path runs it).
int8 runs in either compute dtype (its f32 output mode, `network.py:496`);
fused stages in bf16 only. An f32 forward on CUDA runs with TF32 off
(`no_tf32`), so that cuDNN's convs compute in f32 as XLA's do.
At 608 that routes complex_yolov4's layer 0 to the stem kernel (bf16) and
layers 1, 6, 11, 16 and 19 to the 3x3 kernel; with fused stages, layers
2-10 and 12-23 go to two fused-stage launches and only layers 1 and 11 stay on the 3x3
kernel; with int8 by `quantize.default_skip`, 68 convs go to the int8
kernel.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv3x3 as conv3x3_mod
from ..ops import fused_stage as fused_mod
from ..ops import int8_conv as int8_mod
from ..ops import stem_conv as stem_mod
from ..ops.activations import act
from .bn_train import BN_EPS, batch_count, bn_train
from .quantize import chain_set
from .spec import ConvSpec, MaxPoolSpec, NetSpec, RouteSpec, ShortcutSpec, UpsampleSpec, YoloSpec
from .yolo_head import decode_head, decode_head_raw


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN inside the block, the caller's settings
    restored after: f32 convs and matmuls on the card then compute in f32,
    as the JAX package's do."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def precision_scope(compute_dtype: torch.dtype, device: torch.device):
    """`no_tf32()` for f32 compute on CUDA, else a context that does nothing."""
    if compute_dtype == torch.float32 and torch.device(device).type == "cuda":
        return no_tf32()
    return contextlib.nullcontext()


def kernel_routes(spec: NetSpec, img_size: int,
                  compute_dtype: torch.dtype = torch.bfloat16) -> Dict[int, str]:
    """{layer index: "stem" | "conv3x3"} for the convs the kernels take on a
    square `img_size` input in `compute_dtype` (pure Python, no compute);
    f32 has no stem route."""
    chans = (spec.in_channels,) + spec.out_channels()
    strides = spec.out_strides()
    routes: Dict[int, str] = {}
    for i, layer in enumerate(spec.layers):
        if not isinstance(layer, ConvSpec) or layer.size != 3 or not layer.pad:
            continue
        size_in = img_size // (strides[i - 1] if i else 1)
        if i == 0 and stem_mod.shape_ok(chans[0], layer.filters, 3, layer.stride):
            if compute_dtype == torch.bfloat16:
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


def _other_layer(layer, h: torch.Tensor, outputs: List[Optional[torch.Tensor]],
                 i: int) -> torch.Tensor:
    """Maxpool, upsample, route or shortcut `i` on the running activation `h`
    and the kept outputs of earlier layers."""
    if isinstance(layer, MaxPoolSpec):
        return _maxpool(h, layer.size, layer.stride)
    if isinstance(layer, UpsampleSpec):
        return F.interpolate(h, scale_factor=layer.stride, mode="nearest")
    if isinstance(layer, RouteSpec):
        if len(layer.layers) == 1:
            src = outputs[layer.layers[0]]
            c = src.shape[1] // layer.groups
            return src[:, layer.group_id * c:(layer.group_id + 1) * c]
        return torch.cat([outputs[j] for j in layer.layers], dim=1)
    if isinstance(layer, ShortcutSpec):
        return act(outputs[layer.from_index] + outputs[i - 1], layer.activation)
    raise ValueError(f"unsupported layer {layer!r}")


class Darknet(nn.Module):
    """Folded-BN inference network over a `NetSpec`.

    Args:
      spec: the (unfolded) layer IR; BN is already folded into `state`.
      state: ``{"layer{i}.weight": OIHW, "layer{i}.bias": (C_out,)}`` from
        `weights.from_jax_params`.
      compute_dtype: torch.bfloat16 or torch.float32 (the 3x3 kernel's f32
        instance, cuDNN in f32 with TF32 off, the int8 kernel's f32 output).
      device: where the weights live; inputs must be on it too.
      quant: int8 state from `weights.from_jax_quant`: the convs it holds
        run on the int8 kernel.
      fused_stages: run the planned CSP segments on the fused-stage kernel
        (bf16 only).

    Buffers: per conv ``w{i}``/``b{i}`` in the compute dtype, ``bk{i}``, the
    f32 bias, and for convs a 3x3 kernel can take ``wk{i}``, the weight
    packed once to (9*C_in, C_out) bf16; per quantized conv
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
        if fused_stages and not bf16:
            raise ValueError("fused stages run in bf16 compute only")
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
        # each int8 conv's keyword arguments, made once: the host's cost of a
        # call counts on every one of them
        self._int8_kw: Dict[int, dict] = {}
        for i, (s_x, inv_s_x) in self._quant.items():
            layer = spec.layers[i]
            kw = {"ksize": layer.size, "stride": layer.stride, "s_x": s_x,
                  "activation": layer.activation, "inv_s_x": inv_s_x}
            if i in self._chain:
                kw.update(out="int8", inv_s_next=self._quant[i + 1][1])
            elif not bf16:
                kw.update(out="f32")
            self._int8_kw[i] = kw
        self._last_use = self._liveness(spec)
        self._routes: Dict[tuple, Dict[int, str]] = {}
        self._segments: Dict[int, Dict[int, tuple]] = {}

    @staticmethod
    def _liveness(spec: NetSpec) -> List[int]:
        """The last layer that reads each layer's output."""
        last_use = list(range(len(spec.layers)))
        for i, layer in enumerate(spec.layers):
            srcs = []
            if isinstance(layer, RouteSpec):
                srcs = list(layer.layers)
            elif isinstance(layer, ShortcutSpec):
                srcs = [layer.from_index]
            if i > 0 and not isinstance(layer, RouteSpec):
                srcs.append(i - 1)
            for j in srcs:
                last_use[j] = max(last_use[j], i)
        return last_use

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def replicate(self, device) -> "Darknet":
        """A copy of this network with its buffers on `device` (the
        per-size route and segment caches rebuilt there at first use)."""
        twin = copy.deepcopy(self).to(device)
        twin._routes, twin._segments = {}, {}
        return twin

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
        """Kernel routes of a square `img_size` input: {layer index: "stem" |
        "conv3x3" | "int8" | "fused_stage s-e"}, every layer of a fused
        segment s..e included (no stem in f32 compute, and no 3x3 kernel in
        f32 off CUDA); fused=False: as when the segments are off for a call
        (calibration capture)."""
        key = (img_size, fused)
        if key not in self._routes:
            f32_host = self.compute_dtype == torch.float32 and self.device.type != "cuda"
            routes = {} if f32_host else {
                i: r for i, r in kernel_routes(self.spec, img_size, self.compute_dtype).items()
                if i not in self._quant}
            routes.update({i: "int8" for i in self._quant})
            for start, (seg, _) in (self.segments(img_size) if fused else {}).items():
                routes.update({i: f"fused_stage {start}-{seg.end}"
                               for i in range(start, seg.end + 1)})
            self._routes[key] = dict(sorted(routes.items()))
        return self._routes[key]

    def _int8_conv(self, i: int, h: torch.Tensor, kernels: bool) -> torch.Tensor:
        kw = self._int8_kw[i]
        # int8 from a chained producer, or the compute dtype (bf16 or f32),
        # which the kernel quantizes as it loads it
        x = h.permute(0, 2, 3, 1).contiguous()
        fn = int8_mod.int8_conv if kernels else int8_mod.int8_conv_plain
        y = fn(x, getattr(self, f"wq{i}"), getattr(self, f"wqs{i}"),
               getattr(self, f"bq{i}"), **kw)
        return y.permute(0, 3, 1, 2)

    def _conv(self, i: int, layer: ConvSpec, h: torch.Tensor, route: Optional[str],
              kernels: bool) -> torch.Tensor:
        cd = self.compute_dtype
        if route == "int8":
            return self._int8_conv(i, h, kernels)
        if route is not None:
            wk, bk = getattr(self, f"wk{i}"), getattr(self, f"bk{i}")
            if route == "stem":
                x = h.float().permute(0, 2, 3, 1).contiguous()
                fn = stem_mod.conv3x3_stem if kernels else stem_mod.stem_plain
                y = fn(x, wk, bk, activation=layer.activation)
            else:
                x = h.to(cd).permute(0, 2, 3, 1).contiguous()
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
        with precision_scope(self.compute_dtype, x.device):
            return self._forward(x, kernels, stop_after, capture)

    def _forward(self, x, kernels, stop_after, capture):
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
            elif isinstance(layer, YoloSpec):
                decoded.append(decode_head(outputs[i - 1], layer, img_size))
                h = outputs[i - 1]
            else:
                h = _other_layer(layer, h, outputs, i)
            if stop_after is not None and i >= stop_after:
                return h
            outputs.append(h)
            for j in range(i + 1):
                if outputs[j] is not None and self._last_use[j] <= i:
                    outputs[j] = None
        return torch.cat(decoded, dim=1)


class _ConvParams(nn.Module):
    """One conv's trainable parameters (the JAX tree's ``layer{i}`` entry):
    ``w`` (C_out, C_in, k, k) f32 and ``bn_scale``/``bn_bias`` or ``b``;
    with BN, the running ``mean`` and ``var`` as buffers."""

    def __init__(self, c_in: int, c_out: int, k: int, batch_normalize: bool):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        if batch_normalize:
            self.bn_scale = nn.Parameter(torch.ones(c_out))
            self.bn_bias = nn.Parameter(torch.zeros(c_out))
            self.register_buffer("mean", torch.zeros(c_out))
            self.register_buffer("var", torch.ones(c_out))
        else:
            self.b = nn.Parameter(torch.zeros(c_out))


BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


class TrainDarknet(nn.Module):
    """The trainable network over a `NetSpec`: the train branch of the JAX
    executor (`complex_yolov4_tpu/models/network.py` `apply(train=True)`,
    lines 560-620, without batch packing).

    Per conv: the conv in `compute_dtype` (f32 accumulation; its output in
    the compute dtype), then the train-mode BN of `bn_train` (f32 batch
    statistics, the normalize in f32, the residual in the compute dtype;
    the same Function in both dtypes, with and without a process group);
    the running statistics move by momentum 0.1 with the
    unbiased variance; convs without BN add their bias; the single-exp mish
    of `ops.activations`; the output cast to the compute dtype. The heads
    are decoded in f32 (`decode_head_raw`). No hand kernel runs here, as in
    the JAX train path (`network.py:316, 456, 504, 533`: `not train`).

    Parameters are named as the JAX params tree: ``layer{i}.w`` (OIHW here,
    HWIO there), ``layer{i}.b`` or ``layer{i}.bn_scale``/``.bn_bias``;
    buffers ``layer{i}.mean``/``.var``. `weights.to_train_state` and
    `weights.from_train_state` bridge the trees.

    `process_group` (None, or set by `parallel.wrap_ddp`): the group whose
    ranks' batches form the global batch. With one, train-mode BN takes the
    global batch statistics and gradient (`bn_train`), as the JAX step on a
    data mesh does.
    """

    process_group = None

    def __init__(self, spec: NetSpec, *, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bf16 or f32, got {compute_dtype}")
        self.spec = spec
        self.compute_dtype = compute_dtype
        chans = (spec.in_channels,) + spec.out_channels()
        for i, layer in enumerate(spec.layers):
            if isinstance(layer, ConvSpec):
                self.add_module(f"layer{i}", _ConvParams(chans[i], layer.filters, layer.size,
                                                         layer.batch_normalize))
        self._last_use = Darknet._liveness(spec)

    def _conv(self, i: int, layer: ConvSpec, h: torch.Tensor,
              update_stats: bool = True) -> torch.Tensor:
        cd = self.compute_dtype
        p = getattr(self, f"layer{i}")
        pad = (layer.size - 1) // 2 if layer.pad else 0
        h = F.conv2d(h.to(cd), p.w.to(cd), None, layer.stride, pad)
        if layer.batch_normalize and not self.training:  # the running statistics
            inv = torch.rsqrt(p.var + BN_EPS) * p.bn_scale
            h = (h * inv.to(h.dtype)[None, :, None, None]
                 + (p.bn_bias - p.mean * inv).to(h.dtype)[None, :, None, None])
        elif layer.batch_normalize:
            n = batch_count(h, self.process_group)
            h, mean, var = bn_train(h, p.bn_scale, p.bn_bias, self.process_group)
            if update_stats:
                with torch.no_grad():
                    p.mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
                    p.var.mul_(1 - BN_MOMENTUM).add_(
                        BN_MOMENTUM * var.detach() * (n / max(n - 1, 1)))
        else:
            h = h + p.b.to(h.dtype)[None, :, None, None]
        return act(h, layer.activation).to(cd)

    def _conv_remat(self, i: int, layer: ConvSpec, h: torch.Tensor) -> torch.Tensor:
        """`_conv` under activation checkpointing: only its input is kept
        for the backward, which runs conv, BN and activation again. The
        recomputation leaves the running statistics alone, so they move
        once per step, as without remat."""
        first = [True]

        def run(x):
            update, first[0] = first[0], False
            return self._conv(i, layer, x, update_stats=update)

        return checkpoint(run, h, use_reentrant=False)

    def forward(self, x: torch.Tensor, remat: bool = False) -> List[dict]:
        """(B, C, S, S) f32 raster -> the per-head decode dicts of
        `decode_head_raw` (what `losses.network_loss` reads). In train mode
        BN takes the batch statistics and updates the running ones in
        place; in eval mode (`.eval()`, the JAX `train=False`) it takes the
        running statistics. f32 compute on CUDA needs TF32 off around the
        forward and the backward: the train and eval steps hold that scope
        (`precision_scope`), not the forward.

        remat: activation checkpointing (the JAX step's `remat`, which wraps
        the whole forward in `jax.checkpoint`): each conv with its BN and
        activation keeps only its input for the backward and is run again
        there (`_conv_remat`), so the saved activations shrink to one per
        conv while the values, gradients and running statistics stay those
        of the plain forward. Checkpointing the whole forward at once would
        save little in eager PyTorch: its recomputation would hold every
        activation again at the start of the backward."""
        img_size = x.shape[-1]
        remat = remat and self.training and torch.is_grad_enabled()
        outputs: List[Optional[torch.Tensor]] = []
        heads = []
        h = x
        for i, layer in enumerate(self.spec.layers):
            if isinstance(layer, ConvSpec):
                h = self._conv_remat(i, layer, h) if remat else self._conv(i, layer, h)
            elif isinstance(layer, YoloSpec):
                heads.append(decode_head_raw(outputs[i - 1], layer, img_size))
                h = outputs[i - 1]
            else:
                h = _other_layer(layer, h, outputs, i)
            outputs.append(h)
            for j in range(i + 1):
                if outputs[j] is not None and self._last_use[j] <= i:
                    outputs[j] = None
        return heads

    def to_serving(self, device: torch.device, compute_dtype: torch.dtype) -> "Darknet":
        """The serving `Darknet` of the current parameters and running
        statistics, BN folded in float64 (`weights.fold_batchnorm`)."""
        from . import weights

        params, state = weights.from_train_state(self.spec, self.state_dict())
        return Darknet(self.spec, weights.from_jax_params(self.spec, params, state),
                       compute_dtype=compute_dtype, device=device)
