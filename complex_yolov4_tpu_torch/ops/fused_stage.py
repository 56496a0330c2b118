"""Fused CSP-stage execution: one kernel launch per early-backbone stage.

Counterpart of `complex_yolov4_tpu/ops/fused_stage.py` `apply_segment`. A
segment is a run of stride-1 layers at one resolution (1x1 and 3x3 convs,
shortcut, concat, CSP group slice, identity route) with every channel count
<= 128. Run layer by layer, each of its intermediates makes a round trip
through device memory; the fused kernel reads the segment input once,
keeps every intermediate on chip, and writes only the segment output.

- `SegOp`, `Segment`, `plan_segments`, `_try_segment`, `_halo` and
  `_has_external_reader` are copies of the JAX planner (pure Python);
  `tests/test_torch_port_fused_stage.py` holds the plans equal.
- `pick_tile` replaces the TPU's VMEM row-tile budget with the Hopper tile
  choice of `build_program`: a 2-D window whose live values fit one
  block's shared memory.
- `segment_weights` packs the segment's convs from the module's OIHW state.
- `fused_stage_plain` is the plain PyTorch version, op by op in the plain
  layout of the Pallas kernel: bf16 values, f32 accumulation, the conv
  epilogue cast to bf16 before a bf16 activation (`seg_act`, the kernel's
  own formulas), zero padding before each 3x3.
- `apply_segment` is the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches `cyv4_fused_stage` (`csrc/fused_stage.cu`) or the
  call raises.

The TPU's width-packed `packed2` layout is a lane-layout rewrite of the same
function and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.spec import ConvSpec, NetSpec, RouteSpec, ShortcutSpec
from . import _build
from .activations import ACT_CODES
from .conv3x3 import im2col_nhwc, pack_weight


@dataclass(frozen=True)
class SegOp:
    """One step of a fused segment. `srcs` index previous ops within the
    segment; -1 is the segment input (output of layer `start - 1`)."""

    kind: str                 # conv1x1 | conv3x3 | shortcut | concat | slice | identity
    srcs: Tuple[int, ...]
    layer_index: int          # absolute index in spec.layers
    activation: str = "linear"
    cin: int = 0
    cout: int = 0
    groups: int = 1
    group_id: int = 0


@dataclass(frozen=True)
class Segment:
    start: int                # first spec layer replaced by the kernel
    end: int                  # last spec layer replaced (inclusive)
    ops: Tuple[SegOp, ...]
    halo: int                 # number of 3x3 convs
    cin: int
    cout: int


_MAX_C = 128
_MIN_W = 152
_ACTS = ("mish", "leaky", "relu", "linear")

# Shared memory of one H100 block (232,448 B with the opt-in attribute).
SMEM_LIMIT = 232448
THREADS = 256
WARPS = THREADS // 32
STAGE_BYTES = WARPS * 16 * 16 * 4  # one 16x16 f32 epilogue tile per warp
HEADER_INTS = 20                   # program layout: csrc/fused_stage.cu
ROW_INTS = 20
MAX_PARTS = 4
KIND_CODES = {"conv1x1": 0, "conv3x3": 1, "shortcut": 2}


def plan_segments(spec: NetSpec, img_size: int) -> List[Segment]:
    """Maximal fusable segments for `spec` at `img_size` input resolution.

    A segment is a run of layers at constant resolution where every layer is
    a stride-1 conv (k=1 or 3), a shortcut, or a route whose references all
    resolve inside the segment or to the segment input, with channel counts
    <= _MAX_C. Runs with fewer than 2 convs aren't worth a kernel launch.
    """
    chans = (spec.in_channels,) + spec.out_channels()
    # Resolution at the INPUT of each layer.
    res = []
    h = img_size
    for layer in spec.layers:
        res.append(h)
        if isinstance(layer, ConvSpec) and layer.stride == 2:
            h //= 2
        elif hasattr(layer, "stride") and getattr(layer, "stride", 1) == 2 \
                and not isinstance(layer, ConvSpec):
            h //= 2
        elif layer.__class__.__name__ == "UpsampleSpec":
            h *= getattr(layer, "stride", 2)

    segments: List[Segment] = []
    i = 1  # layer 0 output is the natural first segment input at earliest
    n = len(spec.layers)
    while i < n:
        seg = _try_segment(spec, chans, res, i)
        if seg is not None:
            segments.append(seg)
            i = seg.end + 1
        else:
            i += 1
    return segments


def _try_segment(spec: NetSpec, chans, res, start: int) -> Optional[Segment]:
    n = len(spec.layers)
    w0 = res[start]
    if w0 < _MIN_W:
        return None
    ops: List[SegOp] = []
    produced: Dict[int, int] = {start - 1: -1}  # spec index -> op id
    end = start - 1
    j = start
    while j < n:
        layer = spec.layers[j]
        if res[j] != w0:
            break
        if isinstance(layer, ConvSpec):
            if layer.stride != 1 or layer.size not in (1, 3) or not (
                    layer.pad or layer.size == 1):
                break
            if chans[j] > _MAX_C or layer.filters > _MAX_C:
                break
            if layer.activation not in _ACTS:
                break
            src = produced.get(j - 1)
            if src is None:
                break
            ops.append(SegOp(
                kind="conv1x1" if layer.size == 1 else "conv3x3",
                srcs=(src,), layer_index=j, activation=layer.activation,
                cin=chans[j], cout=layer.filters))
        elif isinstance(layer, ShortcutSpec):
            a = produced.get(j - 1)
            b = produced.get(layer.from_index)
            if a is None or b is None:
                break
            ops.append(SegOp(kind="shortcut", srcs=(a, b), layer_index=j,
                             activation=getattr(layer, "activation", "linear"),
                             cout=chans[j + 1]))
        elif isinstance(layer, RouteSpec):
            srcs = tuple(produced.get(s) for s in layer.layers)
            if any(s is None for s in srcs):
                break
            total_c = sum(chans[s + 1] for s in layer.layers)
            if total_c > _MAX_C and len(srcs) > 1:
                break
            if layer.groups > 1:
                if len(srcs) != 1:
                    break
                ops.append(SegOp(kind="slice", srcs=srcs, layer_index=j,
                                 cin=chans[layer.layers[0] + 1],
                                 cout=chans[j + 1],
                                 groups=layer.groups, group_id=layer.group_id))
            elif len(srcs) == 1:
                ops.append(SegOp(kind="identity", srcs=srcs, layer_index=j,
                                 cout=chans[j + 1]))
            else:
                ops.append(SegOp(kind="concat", srcs=srcs, layer_index=j,
                                 cout=total_c))
        else:
            break
        produced[j] = len(ops) - 1
        end = j
        j += 1

    # Trim trailing ops whose inner outputs are read after the segment: the
    # kernel only materialises the last op.
    while end >= start:
        if not _has_external_reader(spec, start, end):
            break
        end -= 1
        ops.pop()
    convs = sum(1 for o in ops if o.kind in ("conv1x1", "conv3x3"))
    if end - start + 1 < 2 or convs < 2:
        return None
    cin = chans[start]
    if pick_tile(ops, cin) is None:
        return None
    return Segment(start=start, end=end, ops=tuple(ops), halo=_halo(ops),
                   cin=cin, cout=ops[-1].cout or chans[end + 1])


def _halo(ops: Sequence[SegOp]) -> int:
    return sum(1 for o in ops if o.kind == "conv3x3")


def _has_external_reader(spec: NetSpec, start: int, end: int) -> bool:
    """True if any layer AFTER `end` reads an output produced strictly
    inside [start, end - 1] (the kernel only materialises layer `end`)."""
    for j in range(end + 1, len(spec.layers)):
        layer = spec.layers[j]
        refs: List[int] = []
        if isinstance(layer, RouteSpec):
            refs = list(layer.layers)
        elif isinstance(layer, ShortcutSpec):
            refs = [layer.from_index]
        for r in refs:
            if start <= r < end:
                return True
    return False


def seg_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The Pallas kernel's activations (`fused_stage.py` `_ACTS`) in x's
    dtype: mish = x * (q / (q + 2)), q = s*s + 2s, s = exp(min(x, 20)), with
    no branch; leaky = max(x, 0.1 x); relu = max(x, 0). In bf16 the mish
    rounds otherwise than `activations.act` (x * q / (q + 2)): over segment
    2-10 that alone moves the result 1.1e-2 of its scale from the Pallas
    kernel's, against 2.8e-3 with this form (width 76, seeded weights)."""
    if kind == "mish":
        s = torch.exp(torch.clamp(x, max=20.0))
        q = s * s + 2.0 * s
        return x * (q / (q + 2.0))
    if kind == "leaky":
        return torch.maximum(x, x * 0.1)
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "linear":
        return x
    raise ValueError(f"unknown activation {kind!r}")


# ------------------------------------------------------ Hopper program ----

class Program(NamedTuple):
    """A segment laid out for `cyv4_fused_stage`: the computed window is
    `win_h` x `win_w` pixels (win_w a multiple of 16), the output tile is
    (win_h - 2*halo) x (win_w - 2*halo), and `ints` is the int32 op table
    (header + one row per conv/shortcut; csrc/fused_stage.cu)."""

    win_h: int
    win_w: int
    halo: int
    smem_bytes: int
    ints: Tuple[int, ...]


def _value_parts(ops: Sequence[SegOp], cin: int):
    """Each op's value as parts [(buffer, channel offset, channels)] of
    storage buffers; identity, slice and concat only alias parts. Returns
    (parts per op id, channels per buffer, producing op per buffer)."""
    buf_c = [cin]                 # buffer 0: the segment input
    buf_op = [-1]
    vals: Dict[int, List[Tuple[int, int, int]]] = {-1: [(0, 0, cin)]}
    for oi, op in enumerate(ops):
        if op.kind in ("conv1x1", "conv3x3", "shortcut"):
            buf_c.append(op.cout)
            buf_op.append(oi)
            vals[oi] = [(len(buf_c) - 1, 0, op.cout)]
        elif op.kind == "identity":
            vals[oi] = list(vals[op.srcs[0]])
        elif op.kind == "concat":
            vals[oi] = [p for s in op.srcs for p in vals[s]]
        elif op.kind == "slice":
            src = vals[op.srcs[0]]
            total = sum(c for _, _, c in src)
            c = total // op.groups
            lo, hi = op.group_id * c, (op.group_id + 1) * c
            parts, at = [], 0
            for b, off, pc in src:  # channel range [lo, hi) of the parts
                a, z = max(lo, at), min(hi, at + pc)
                if a < z:
                    parts.append((b, off + a - at, z - a))
                at += pc
            vals[oi] = parts
        else:
            raise ValueError(f"unknown segment op {op.kind!r}")
    return vals, buf_c, buf_op


def build_program(ops: Sequence[SegOp], cin: int, win_h: int, win_w: int) -> Program:
    """Lay the segment out in one block's shared memory for a win_h x win_w
    window: every buffer is a (win_h+2) x (win_w+2) pixel slot (a one-pixel
    border, so each 3x3 tap of 16 consecutive pixels is one strided WMMA
    load) of `channels` bf16, placed greedily by size over live ranges. Raises
    ValueError for what the kernel cannot take."""
    halo = _halo(ops)
    if win_w % 16 or win_w <= 2 * halo or win_h <= 2 * halo:
        raise ValueError("window too small for the halo")
    vals, buf_c, buf_op = _value_parts(ops, cin)
    n_ops = len(ops)
    for c in buf_c:
        if c % 16 or c > _MAX_C:
            raise ValueError(f"buffer of {c} channels: need a multiple of 16 up to 128")
    last_use = [0] * len(buf_c)
    for oi, op in enumerate(ops):
        for s in op.srcs:
            for b, _, _ in vals[s]:
                last_use[b] = max(last_use[b], oi)
    for b, _, _ in vals[n_ops - 1]:
        last_use[b] = n_ops  # the output: live to the end
    px = (win_h + 2) * (win_w + 2)
    # Greedy by size: the largest buffers first, each at the lowest offset
    # clear of every placed buffer whose live range [def, last use] meets
    # its own. A buffer is defined by its op, so an op's output never
    # shares memory with its inputs.
    defined = [-1] + [buf_op[b] for b in range(1, len(buf_c))]
    offsets = [0] * len(buf_c)
    placed: List[int] = []
    peak = 0
    for b in sorted(range(len(buf_c)), key=lambda b: (-buf_c[b], defined[b])):
        size = px * buf_c[b]
        busy = sorted((offsets[o], offsets[o] + px * buf_c[o]) for o in placed
                      if defined[b] <= last_use[o] and defined[o] <= last_use[b])
        at = 0
        for s, e in busy:
            if at + size <= s:
                break
            at = max(at, e)
        offsets[b] = at
        placed.append(b)
        peak = max(peak, at + size)
    rows: List[int] = []
    for oi, op in enumerate(ops):
        if op.kind not in KIND_CODES:
            continue
        b = buf_op.index(oi)
        srcs = [p for s in op.srcs[:1 if op.kind != "shortcut" else 2]
                for p in vals[s]]
        if op.kind == "shortcut" and len(srcs) != 2:
            raise ValueError("shortcut over a multi-part value")
        if len(srcs) > MAX_PARTS:
            raise ValueError("too many parts")
        row = [KIND_CODES[op.kind], ACT_CODES[op.activation], op.cout,
               offsets[b], 0, 0, len(srcs)]
        for pb, off, c in srcs:
            if off % 16 or c % 16:
                raise ValueError("part not 16-channel aligned")
            row += [offsets[pb] + off, buf_c[pb], c]
        rows += row + [0] * (ROW_INTS - len(row))
    out = vals[n_ops - 1]
    if len(out) > MAX_PARTS:
        raise ValueError("too many output parts")
    header = [len(rows) // ROW_INTS, win_w, win_h, halo, offsets[0], cin, peak,
              len(out)]
    for pb, off, c in out:
        header += [offsets[pb] + off, buf_c[pb], c]
    header += [0] * (HEADER_INTS - len(header))
    smem = peak * 2 + STAGE_BYTES
    return Program(win_h, win_w, halo, smem, tuple(header + rows))


def _tile_candidates(halo: int):
    for win_w in (16, 32, 48, 64):
        for win_h in range(2 * halo + 1, 65):
            if win_w > 2 * halo:
                yield win_h, win_w


def pick_tile(ops: Sequence[SegOp], cin: int) -> Optional[Program]:
    """The Hopper tile: of the windows whose buffers fit one block's shared
    memory, the one with the largest share of useful output pixels (output
    tile / computed window; ties go to the larger tile). None when no window
    fits or the kernel cannot take the segment."""
    halo = _halo(ops)
    best, best_key = None, None
    for win_h, win_w in _tile_candidates(halo):
        try:
            prog = build_program(ops, cin, win_h, win_w)
        except ValueError:
            return None
        if prog.smem_bytes > SMEM_LIMIT:
            continue
        out_px = (win_h - 2 * halo) * (win_w - 2 * halo)
        key = (out_px / (win_h * win_w), out_px)
        if best_key is None or key > best_key:
            best, best_key = prog, key
    return best


# ------------------------------------------------------------- weights ----

class SegmentWeights(NamedTuple):
    """A segment's conv weights in op order: `convs[k]` is (w, bias) of the
    k-th conv, w (C_in, C_out) bf16 for a 1x1 and (9*C_in, C_out) bf16 in
    (ky, kx, ci) row order for a 3x3, bias (C_out,) f32. `w_flat`/`b_flat`
    hold the same, each conv at a 16-element-aligned offset, and `program`
    is the int32 op table with those offsets, for the kernel."""

    convs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    w_flat: torch.Tensor
    b_flat: torch.Tensor
    program: torch.Tensor
    layout: Program


def segment_weights(seg: Segment, state: Mapping[str, torch.Tensor]) -> SegmentWeights:
    """Pack the segment's convs from ``{"layer{i}.weight": OIHW,
    "layer{i}.bias": (C_out,)}`` (the module state), on the weights'
    device."""
    convs = []
    for op in seg.ops:
        if op.kind not in ("conv1x1", "conv3x3"):
            continue
        w = state[f"layer{op.layer_index}.weight"]
        b = state[f"layer{op.layer_index}.bias"].float().contiguous()
        if op.kind == "conv1x1":
            w2 = w[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        else:
            w2 = pack_weight(w)
        convs.append((w2, b))
    layout = pick_tile(seg.ops, seg.cin)
    if layout is None:
        raise ValueError(f"segment {seg.start}-{seg.end} has no Hopper tile")
    dev = convs[0][0].device
    w_parts, b_parts, w_offs, b_offs = [], [], [], []
    wn = bn = 0
    for w2, b in convs:
        w_offs.append(wn)
        b_offs.append(bn)
        pad_w = -w2.numel() % 16
        w_parts += [w2.reshape(-1), torch.zeros(pad_w, dtype=torch.bfloat16, device=dev)]
        b_parts.append(b)
        wn += w2.numel() + pad_w
        bn += b.numel()
    ints = list(layout.ints)
    row = HEADER_INTS
    for k in range(len(convs)):
        while ints[row] == KIND_CODES["shortcut"]:
            row += ROW_INTS
        ints[row + 4], ints[row + 5] = w_offs[k], b_offs[k]
        row += ROW_INTS
    program = torch.tensor(ints, dtype=torch.int32, device=dev)
    return SegmentWeights(tuple(convs), torch.cat(w_parts), torch.cat(b_parts),
                          program, layout)


# ------------------------------------------------------- plain version ----

def fused_stage_plain(seg: Segment, x: torch.Tensor, weights: SegmentWeights) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on x's device: the ops of the
    segment one by one over the whole image, in the plain layout of
    `fused_stage.py` `_build_kernel` (bf16 values; products of bf16 with f32
    accumulation; conv epilogue `seg_act(bf16(acc + b))` in bf16; shortcut
    `seg_act(a + b)` in bf16; a 3x3 pads its input with zeros)."""
    b_sz, h, w, _ = x.shape
    vals: Dict[int, torch.Tensor] = {-1: x.to(torch.bfloat16)}
    k = 0
    for oi, op in enumerate(seg.ops):
        if op.kind in ("conv1x1", "conv3x3"):
            wk, bk = weights.convs[k]
            k += 1
            src = vals[op.srcs[0]].float()
            patches = src if op.kind == "conv1x1" else im2col_nhwc(src, 1)
            acc = patches @ wk.float()
            vals[oi] = seg_act((acc + bk).to(torch.bfloat16), op.activation)
        elif op.kind == "shortcut":
            vals[oi] = seg_act(vals[op.srcs[0]] + vals[op.srcs[1]], op.activation)
        elif op.kind == "concat":
            vals[oi] = torch.cat([vals[s] for s in op.srcs], dim=-1)
        elif op.kind == "slice":
            v = vals[op.srcs[0]]
            c = v.shape[-1] // op.groups
            vals[oi] = v[..., op.group_id * c:(op.group_id + 1) * c]
        elif op.kind == "identity":
            vals[oi] = vals[op.srcs[0]]
        else:
            raise ValueError(f"unknown segment op {op.kind!r}")
    return vals[len(seg.ops) - 1].contiguous()


def _check(seg: Segment, x: torch.Tensor, weights: SegmentWeights) -> None:
    if x.dim() != 4 or x.shape[-1] != seg.cin:
        raise ValueError(f"x must be (B, H, W, {seg.cin}), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    n_convs = sum(1 for o in seg.ops if o.kind in ("conv1x1", "conv3x3"))
    if len(weights.convs) != n_convs:
        raise ValueError(f"segment has {n_convs} convs, weights {len(weights.convs)}")
    if not (x.device == weights.w_flat.device == weights.b_flat.device
            == weights.program.device):
        raise ValueError("x and the segment weights must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def apply_segment(seg: Segment, x: torch.Tensor, weights: SegmentWeights) -> torch.Tensor:
    """Run one fused segment: x (B, H, W, C_in) bf16 NHWC -> (B, H, W,
    C_out) bf16. `weights` from `segment_weights(seg, ...)`."""
    _check(seg, x, weights)
    if x.device.type == "cpu":
        return fused_stage_plain(seg, x, weights)
    b_sz, h, w, c_in = x.shape
    lay = weights.layout
    out = torch.empty((b_sz, h, w, seg.cout), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.cyv4_fused_stage(x.data_ptr(), weights.w_flat.data_ptr(),
                                weights.b_flat.data_ptr(), weights.program.data_ptr(),
                                out.data_ptr(), b_sz, h, w, c_in, seg.cout,
                                lay.win_h, lay.win_w, lay.halo, lay.smem_bytes, stream)
    _build.check(code, "cyv4_fused_stage")
    apply_segment.launches += 1
    return out


apply_segment.launches = 0  # kernel launches, read by chip_smoke.py
