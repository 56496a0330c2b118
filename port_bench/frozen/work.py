"""The work of a configuration counted from its layer list, and the H100's
published peaks (frozen copies of `chip_smoke.py`'s `conv_work` and
`bound_ms`).

Peaks of one NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet, dense
(no sparsity), at the 700 W limit: 989 TFLOP/s bf16 tensor core, 1,979
TOP/s int8 tensor core, 3.35 TB/s HBM3. A card set below 700 W runs
slower; the run prints its power limit beside every share.

Operations: only convolutions count, 2 per multiply-add; every other
layer's arithmetic could be fused into a conv's load or epilogue. Bytes
of a range of layers: only what crosses the range's edge, since a kernel
may keep everything else on chip (`range_bound_s`). So the bound is the
least time the card could take however a later change fuses the layers,
and a share of it cannot pass 100%.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def conv_shapes(layers: List[dict], img_size: int, in_channels: int = 3) -> Dict[int, dict]:
    """{conv index: {h (input side), c_in, c_out, k, stride}} at a square
    `img_size`, from the configuration's layer list."""
    chans: List[int] = []
    strides: List[int] = []
    prev_c, prev_s = in_channels, 1
    out: Dict[int, dict] = {}
    for i, layer in enumerate(layers):
        kind = layer["type"]
        if kind == "conv":
            out[i] = {"h": img_size // prev_s, "c_in": prev_c, "c_out": layer["filters"],
                      "k": layer["size"], "stride": layer["stride"]}
            prev_c, prev_s = layer["filters"], prev_s * layer["stride"]
        elif kind == "maxpool":
            prev_s = prev_s * layer["stride"]
        elif kind == "upsample":
            prev_s = prev_s // layer["stride"]
        elif kind == "route":
            src = layer["layers"]
            prev_c = (chans[src[0]] // layer["groups"] if len(src) == 1
                      else sum(chans[j] for j in src))
            prev_s = strides[src[0]]
        chans.append(prev_c)
        strides.append(prev_s)
    return out


def conv_flops(shape: dict, batch: int = 1) -> float:
    ho = shape["h"] // shape["stride"]
    return 2.0 * batch * ho * ho * shape["c_out"] * shape["k"] ** 2 * shape["c_in"]


def flops_per_frame(layers: List[dict], img_size: int) -> float:
    return sum(conv_flops(s) for s in conv_shapes(layers, img_size).values())


def _reads(layer: dict, j: int) -> List[int]:
    if layer["type"] == "route":
        return list(layer["layers"])
    srcs = [layer["from"]] if layer["type"] == "shortcut" else []
    return srcs + ([j - 1] if j > 0 else [])


def _out_sizes(layers: List[dict], img_size: int, in_channels: int = 3) -> List[int]:
    """Elements per frame of each layer's output."""
    sizes, chans, sides = [], [], []
    c, side = in_channels, img_size
    for i, layer in enumerate(layers):
        kind = layer["type"]
        if kind == "conv":
            c, side = layer["filters"], side // layer["stride"]
        elif kind == "maxpool":
            side = side // layer["stride"]
        elif kind == "upsample":
            side = side * layer["stride"]
        elif kind == "route":
            src = layer["layers"]
            c = chans[src[0]] // layer["groups"] if len(src) == 1 else sum(chans[j] for j in src)
            side = sides[src[0]]
        chans.append(c)
        sides.append(side)
        sizes.append(c * side * side)
    return sizes


def _crossing(layers: List[dict], sizes: List[int], i: int) -> int:
    """Elements per frame that must be stored for a consumer of layer i's
    output: a route stores nothing of its own (its sources), an upsample
    no more than its source."""
    layer = layers[i]
    if layer["type"] == "route":
        src = layer["layers"]
        whole = sum(_crossing(layers, sizes, j) for j in src)
        return whole // layer["groups"] if len(src) == 1 else whole
    if layer["type"] == "upsample":
        return min(sizes[i], _crossing(layers, sizes, i - 1))
    return sizes[i]


def range_bound_s(layers: List[dict], img_size: int, batch: int, int8: Iterable[int],
                  first: int, last: Optional[int]) -> float:
    """The least time the card could take for layers first..last (last
    None: to the end), whatever kernels compute them and however they are
    fused: the larger of the convs' operations at the peak of each conv's
    dtype and the bytes that cross the range's edge at the HBM rate. Those
    bytes: what the range reads from earlier layers (bf16; the f32 raster
    for layer 0), what later layers read from it (bf16), its decoded heads
    (f32), and its conv weights (int8 or bf16) and f32 biases, each once."""
    last = len(layers) - 1 if last is None else last
    q = set(int8)
    shapes = conv_shapes(layers, img_size)
    sizes = _out_sizes(layers, img_size)
    inside = range(first, last + 1)
    ops_s = sum(conv_flops(shapes[i], batch) / PEAK_OPS_PER_S["int8" if i in q else "bf16"]
                for i in inside if i in shapes)
    ins = {s for j in inside for s in _reads(layers[j], j) if s < first}
    moved = sum(batch * _crossing(layers, sizes, s) * 2 for s in ins)
    if first == 0:
        moved += batch * img_size * img_size * 3 * 4
    outs = {s for j in range(last + 1, len(layers)) for s in _reads(layers[j], j)
            if first <= s <= last and layers[j]["type"] != "yolo"}
    moved += sum(batch * _crossing(layers, sizes, s) * 2 for s in outs)
    for j in inside:
        layer = layers[j]
        if layer["type"] == "yolo":
            g = img_size // layer["stride"]
            moved += batch * g * g * len(layer["anchors"]) * (7 + layer["num_classes"]) * 4
        if j in shapes:
            sh = shapes[j]
            moved += sh["k"] ** 2 * sh["c_in"] * sh["c_out"] * (1 if j in q else 2) + sh["c_out"] * 4
    return max(ops_s, moved / HBM_BYTES_PER_S)


def peak_seconds_per_frame(layers: List[dict], img_size: int, int8: Iterable[int] = ()) -> float:
    """Each conv's operations over the peak of its dtype in the cell, summed:
    the seconds one frame takes at the tensor cores' peak (mfu's numerator
    per frame)."""
    q = set(int8)
    return sum(conv_flops(s) / PEAK_OPS_PER_S["int8" if i in q else "bf16"]
               for i, s in conv_shapes(layers, img_size).items())
