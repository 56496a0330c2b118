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
- The kernel is the `torch.library` custom op ``cyv4::fused_stage``. Its
  arguments alone determine a launch, so that a program exported with
  `torch.export` runs in a process that planned nothing: the input, the
  packed weights and biases, the int32 op table (`Program`), the
  segment's ops as an int list (`segment_code`) and the tile (window
  height and width, halo, shared-memory bytes). Its CUDA implementation
  launches `cyv4_fused_stage` (`csrc/fused_stage.cu`) or raises; its CPU
  implementation decodes the segment and runs the plain version; its fake
  implementation checks the operands against the code and gives the
  output's shape, and builds nothing.
- `apply_segment` is the wrapper that calls the op.

The TPU's width-packed `packed2` layout is a lane-layout rewrite of the same
function and is not ported.
"""

from __future__ import annotations

import functools
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
HEADER_INTS = 32                   # program layout: csrc/fused_stage.cu
ROW_INTS = 32
PART_AT = 11                       # first part of a row: (buffer, C, channel offset, channels)
MAX_PARTS = 4
# Instruction cost of one output value's epilogue (bias, bf16 rounding,
# activation) in multiply-adds, for the tile choice: ~0.4 warp instructions
# a value against 2048 multiply-adds per mma.sync.
EPI_MACS = 100
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
    """A segment laid out for `cyv4_fused_stage`: the window is `win_h` x
    `win_w` pixels, the output tile (win_h - 2*halo) x (win_w - 2*halo), and
    `ints` the int32 op table (header + one row per conv/shortcut;
    csrc/fused_stage.cu)."""

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


class _Layout(NamedTuple):
    """What of a program does not depend on the window: buffer offsets in
    channels per pixel (a buffer's offset in elements is px times this),
    the kernel ops' rows as (op id, output buffer, input parts), each row's
    region growth e (3x3 convs after it) and each conv's weight elements."""

    vals: Dict[int, List[Tuple[int, int, int]]]
    buf_c: List[int]
    chan_off: List[int]
    peak_c: int
    rows: List[Tuple[int, int, List[Tuple[int, int, int]]]]
    grow: List[int]
    w_elems: List[int]
    slot: int


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def _layout(ops: Sequence[SegOp], cin: int) -> _Layout:
    """Raises ValueError for what the kernel cannot take."""
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
    # Greedy by size: the largest buffers first, each at the lowest offset
    # clear of every placed buffer whose live range [def, last use] meets
    # its own. A buffer is defined by its op, so an op's output never
    # shares memory with its inputs. Sizes are px * channels for every
    # buffer, so the placement is made in channels.
    defined = [-1] + [buf_op[b] for b in range(1, len(buf_c))]
    chan_off = [0] * len(buf_c)
    placed: List[int] = []
    peak = 0
    for b in sorted(range(len(buf_c)), key=lambda b: (-buf_c[b], defined[b])):
        busy = sorted((chan_off[o], chan_off[o] + buf_c[o]) for o in placed
                      if defined[b] <= last_use[o] and defined[o] <= last_use[b])
        at = 0
        for s, e in busy:
            if at + buf_c[b] <= s:
                break
            at = max(at, e)
        chan_off[b] = at
        placed.append(b)
        peak = max(peak, at + buf_c[b])
    rows, grow, w_elems = [], [], []
    for oi, op in enumerate(ops):
        if op.kind not in KIND_CODES:
            continue
        srcs = [p for s in op.srcs[:1 if op.kind != "shortcut" else 2] for p in vals[s]]
        if op.kind == "shortcut" and len(srcs) != 2:
            raise ValueError("shortcut over a multi-part value")
        if len(srcs) > MAX_PARTS:
            raise ValueError("too many parts")
        if any(off % 16 or c % 16 for _, off, c in srcs):
            raise ValueError("part not 16-channel aligned")
        rows.append((oi, buf_op.index(oi), srcs))
        grow.append(sum(1 for o in ops[oi + 1:] if o.kind == "conv3x3"))
        if op.kind != "shortcut":
            taps = 9 if op.kind == "conv3x3" else 1
            w_elems.append(_round(taps * op.cin * op.cout, 64))
    if len(vals[n_ops - 1]) > MAX_PARTS:
        raise ValueError("too many output parts")
    # two weight slots at the two ends of one area: consecutive convs never
    # share memory, so the next conv's weights load during the current one
    slot = max([a + b for a, b in zip(w_elems, w_elems[1:])] + w_elems)
    return _Layout(vals, buf_c, chan_off, peak, rows, grow, w_elems, slot)


def _smem_bytes(lay: _Layout, px: int) -> int:
    return 2 * (_round(px * lay.peak_c, 64) + lay.slot)


def build_program(ops: Sequence[SegOp], cin: int, win_h: int, win_w: int,
                  lay: Optional[_Layout] = None) -> Program:
    """Lay the segment out in one block's shared memory for a win_h x win_w
    window: every buffer holds the window's px = win_h * win_w pixels of
    `channels` bf16 (each pixel's 16-byte chunks swizzled in the kernel),
    placed by size over live ranges; after them the two weight slots.
    Row fields (csrc/fused_stage.cu): kind, act, cout, output buffer,
    weight and bias offsets in the packed weights (`segment_weights`),
    parts, region growth, weight slot, weight rows, next conv row, then the
    parts. Raises ValueError for what the kernel cannot take."""
    halo = _halo(ops)
    if win_w <= 2 * halo or win_h <= 2 * halo:
        raise ValueError("window too small for the halo")
    lay = lay or _layout(ops, cin)
    px = win_h * win_w
    base = [px * c for c in lay.chan_off]
    vals_elems = _round(px * lay.peak_c, 64)
    conv_rows = [r for r, (oi, _, _) in enumerate(lay.rows) if ops[oi].kind != "shortcut"]
    rows: List[int] = []
    k = 0
    for r, (oi, b, srcs) in enumerate(lay.rows):
        op = ops[oi]
        row = [KIND_CODES[op.kind], ACT_CODES[op.activation], op.cout, base[b], 0, 0,
               len(srcs), lay.grow[r], 0, 0, -1]
        if op.kind != "shortcut":
            w_at = 0 if k % 2 == 0 else lay.slot - lay.w_elems[k]
            row[8] = vals_elems + w_at
            row[9] = (9 if op.kind == "conv3x3" else 1) * op.cin
            row[10] = conv_rows[k + 1] if k + 1 < len(conv_rows) else -1
            k += 1
        for pb, off, c in srcs:
            row += [base[pb], lay.buf_c[pb], off, c]
        rows += row + [0] * (ROW_INTS - len(row))
    out = lay.vals[len(ops) - 1]
    header = [len(lay.rows), win_w, win_h, halo, base[0], cin, vals_elems, len(out)]
    for pb, off, c in out:
        header += [base[pb], lay.buf_c[pb], off, c]
    header += [0] * (24 - len(header)) + [conv_rows[0]]
    header += [0] * (HEADER_INTS - len(header))
    return Program(win_h, win_w, halo, _smem_bytes(lay, px), tuple(header + rows))


def _cost_per_pixel(ops: Sequence[SegOp], lay: _Layout, win_h: int, win_w: int,
                    halo: int) -> float:
    """Multiply-adds (and their epilogue's equivalent) a block executes per
    output pixel: each kernel op over its region."""
    ty, tx = win_h - 2 * halo, win_w - 2 * halo
    cost = 0.0
    for (oi, _, _), e in zip(lay.rows, lay.grow):
        op = ops[oi]
        macs = 0 if op.kind == "shortcut" else \
            (9 if op.kind == "conv3x3" else 1) * op.cin * op.cout
        cost += (macs + EPI_MACS * op.cout) * (ty + 2 * e) * (tx + 2 * e)
    return cost / (ty * tx)


def pick_tile(ops: Sequence[SegOp], cin: int) -> Optional[Program]:
    """The Hopper tile: of the windows up to 64 x 64 whose buffers and
    weight slots fit one block's shared memory, the one that executes the
    least work per output pixel (ties go to the larger tile). None when no
    window fits or the kernel cannot take the segment."""
    halo = _halo(ops)
    try:
        lay = _layout(ops, cin)
    except ValueError:
        return None
    best, best_key = None, None
    for win_h in range(2 * halo + 1, 65):
        for win_w in range(2 * halo + 1, 65):
            if _smem_bytes(lay, win_h * win_w) > SMEM_LIMIT:
                break
            key = (_cost_per_pixel(ops, lay, win_h, win_w, halo), -win_h * win_w)
            if best_key is None or key < best_key:
                best, best_key = (win_h, win_w), key
    if best is None:
        return None
    return build_program(ops, cin, *best, lay=lay)


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
    layout: Optional[Program]      # None where the plain version alone reads them


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


# ------------------------------------------------------ the custom op ----

KINDS = ("conv1x1", "conv3x3", "shortcut", "concat", "slice", "identity")
CODE_HEAD = 3                      # cin, cout, number of ops
OP_FIELDS = 7                      # kind, act, cin, cout, groups, group id, sources


@functools.lru_cache(maxsize=64)
def segment_code(seg: Segment) -> Tuple[int, ...]:
    """The segment as the op's int list: (cin, cout, number of ops), then
    per op (kind, activation code, cin, cout, groups, group id, number of
    sources, the sources...), with the kinds of `KINDS` and the activation
    codes of `ACT_CODES`; a source is an op index, -1 the segment input.
    `decode_segment` inverts it (layer indices aside)."""
    code = [seg.cin, seg.cout, len(seg.ops)]
    for op in seg.ops:
        code += [KINDS.index(op.kind), ACT_CODES[op.activation], op.cin, op.cout,
                 op.groups, op.group_id, len(op.srcs), *op.srcs]
    return tuple(code)


@functools.lru_cache(maxsize=64)
def decode_segment(code: Tuple[int, ...]) -> Segment:
    """The `Segment` of `segment_code` (its ops' layer indices 0..n-1)."""
    acts = {v: k for k, v in ACT_CODES.items()}
    cin, cout, n = code[:CODE_HEAD]
    ops, at = [], CODE_HEAD
    for i in range(n):
        kind, act, c_in, c_out, groups, gid, n_src = code[at:at + OP_FIELDS]
        srcs = tuple(code[at + OP_FIELDS:at + OP_FIELDS + n_src])
        at += OP_FIELDS + n_src
        ops.append(SegOp(kind=KINDS[kind], srcs=srcs, layer_index=i, activation=acts[act],
                         cin=c_in, cout=c_out, groups=groups, group_id=gid))
    if at != len(code):
        raise ValueError(f"segment code of {len(code)} ints, {at} read")
    return Segment(start=0, end=n - 1, ops=tuple(ops), halo=_halo(ops), cin=cin, cout=cout)


def _conv_sizes(seg: Segment):
    """(weight elements, bias elements) of each conv, in op order."""
    return [((9 if o.kind == "conv3x3" else 1) * o.cin * o.cout, o.cout)
            for o in seg.ops if o.kind in ("conv1x1", "conv3x3")]


def _check(seg: Segment, x, w_flat, b_flat, program) -> None:
    if x.dim() != 4 or x.shape[-1] != seg.cin:
        raise ValueError(f"x must be (B, H, W, {seg.cin}), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    sizes = _conv_sizes(seg)
    w_n = sum(w + -w % 16 for w, _ in sizes)
    b_n = sum(b for _, b in sizes)
    if tuple(w_flat.shape) != (w_n,) or tuple(b_flat.shape) != (b_n,):
        raise ValueError(f"segment of {len(sizes)} convs takes {w_n} weights and {b_n} biases, "
                         f"got {tuple(w_flat.shape)} and {tuple(b_flat.shape)}")
    if w_flat.dtype != torch.bfloat16 or b_flat.dtype != torch.float32 \
            or program.dtype != torch.int32:
        raise TypeError("w_flat must be bf16, b_flat f32 and program int32")
    if not (x.device == w_flat.device == b_flat.device == program.device):
        raise ValueError("x and the segment weights must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _unpack(seg: Segment, w_flat, b_flat):
    """The (w, bias) of each conv of `segment_weights`' flat packing."""
    convs, wn, bn = [], 0, 0
    for op, (w_elems, b_elems) in zip((o for o in seg.ops
                                       if o.kind in ("conv1x1", "conv3x3")), _conv_sizes(seg)):
        rows = w_elems // op.cout
        convs.append((w_flat[wn:wn + w_elems].reshape(rows, op.cout), b_flat[bn:bn + b_elems]))
        wn += w_elems + -w_elems % 16
        bn += b_elems
    return tuple(convs)


OP = "cyv4::fused_stage"
torch.library.define(OP, "(Tensor x, Tensor w_flat, Tensor b_flat, Tensor program, "
                         "int[] code, int[] tile) -> Tensor")


@torch.library.register_fake(OP)
def _fake(x, w_flat, b_flat, program, code, tile):
    seg = decode_segment(tuple(code))
    _check(seg, x, w_flat, b_flat, program)
    return x.new_empty((*x.shape[:3], seg.cout))


@torch.library.impl(OP, "CPU")
def _cpu(x, w_flat, b_flat, program, code, tile):
    seg = decode_segment(tuple(code))
    _check(seg, x, w_flat, b_flat, program)
    weights = SegmentWeights(_unpack(seg, w_flat, b_flat), w_flat, b_flat, program, None)
    return fused_stage_plain(seg, x, weights)


@torch.library.impl(OP, "CUDA")
def _cuda(x, w_flat, b_flat, program, code, tile):
    cin, cout = code[0], code[1]
    _check(decode_segment(tuple(code)), x, w_flat, b_flat, program)
    win_h, win_w, halo, smem_bytes = tile
    b_sz, h, w, _ = x.shape
    out = torch.empty((b_sz, h, w, cout), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.cyv4_fused_stage(x.data_ptr(), w_flat.data_ptr(), b_flat.data_ptr(),
                               program.data_ptr(), out.data_ptr(), b_sz, h, w, cin, cout,
                               win_h, win_w, halo, smem_bytes, stream)
    _build.check(err, "cyv4_fused_stage")
    apply_segment.launches += 1
    return out


_op = torch.ops.cyv4.fused_stage.default


def apply_segment(seg: Segment, x: torch.Tensor, weights: SegmentWeights) -> torch.Tensor:
    """Run one fused segment: x (B, H, W, C_in) bf16 NHWC -> (B, H, W,
    C_out) bf16, through the op ``cyv4::fused_stage``. `weights` from
    `segment_weights(seg, ...)`."""
    lay = weights.layout
    return _op(x, weights.w_flat, weights.b_flat, weights.program, list(segment_code(seg)),
               [lay.win_h, lay.win_w, lay.halo, lay.smem_bytes])


apply_segment.launches = 0  # kernel launches, read by chip_smoke.py
