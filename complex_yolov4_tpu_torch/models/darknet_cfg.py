"""Darknet ``.cfg`` ingestion: text -> NetSpec.

Feature parity with the reference's cfg DSL support
(reference: src/models/darknet_utils.py:17-48 parse, src/models/darknet2pytorch.py:235-401
network construction), restricted to the block types the Complex-YOLO model
family actually uses: net, convolutional, maxpool, route (incl. CSP group
routes), shortcut, upsample, yolo.

Deliberate fix vs the reference: a yolo block without ``scale_x_y`` defaults to
1.0 instead of raising KeyError (the reference crashes on its own
complex_yolov3_tiny.cfg, whose yolo blocks lack the key).

A copy of `complex_yolov4_tpu/models/darknet_cfg.py`; `tests/test_torch_port_copies.py` holds it
equal to the original.
"""

from __future__ import annotations

import math
from typing import Dict, List

from .spec import (
    ConvSpec,
    MaxPoolSpec,
    NetSpec,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)


def parse_cfg_blocks(text: str) -> List[Dict[str, str]]:
    """Parse cfg text into a list of {key: value} dicts, one per [section]."""
    blocks: List[Dict[str, str]] = []
    current: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip() if raw.lstrip().startswith("#") else raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            current = {"type": line[1 : line.index("]")]}
            blocks.append(current)
        elif "=" in line and blocks:
            key, value = line.split("=", 1)
            current[key.strip()] = value.strip()
    return blocks


def netspec_from_cfg(path_or_text: str, name: str = "") -> NetSpec:
    """Build a NetSpec from a darknet cfg file path or cfg text."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()
        if not name:
            name = path_or_text.rsplit("/", 1)[-1].removesuffix(".cfg")
    blocks = parse_cfg_blocks(text)
    if not blocks or blocks[0]["type"] != "net":
        raise ValueError("cfg must start with a [net] block")

    net = blocks[0]
    width = int(net.get("width", 608))
    height = int(net.get("height", 608))
    in_channels = int(net.get("channels", 3))

    layers: List = []
    strides: List[int] = []  # cumulative stride per emitted layer
    prev_stride = 1

    def cur_index() -> int:
        return len(layers)

    for block in blocks[1:]:
        btype = block["type"]
        if btype == "convolutional":
            spec = ConvSpec(
                filters=int(block["filters"]),
                size=int(block["size"]),
                stride=int(block.get("stride", 1)),
                pad=bool(int(block.get("pad", 0))),
                batch_normalize=bool(int(block.get("batch_normalize", 0))),
                activation=block.get("activation", "linear"),
            )
            prev_stride *= spec.stride
            layers.append(spec)
            strides.append(prev_stride)
        elif btype == "maxpool":
            spec = MaxPoolSpec(size=int(block["size"]), stride=int(block.get("stride", 1)))
            prev_stride *= spec.stride
            layers.append(spec)
            strides.append(prev_stride)
        elif btype == "upsample":
            spec = UpsampleSpec(stride=int(block.get("stride", 2)))
            prev_stride //= spec.stride
            layers.append(spec)
            strides.append(prev_stride)
        elif btype == "route":
            idx = cur_index()
            refs = tuple(int(s) if int(s) >= 0 else int(s) + idx for s in block["layers"].split(","))
            spec = RouteSpec(
                layers=refs,
                groups=int(block.get("groups", 1)),
                group_id=int(block.get("group_id", 0)),
            )
            prev_stride = strides[refs[0]]
            layers.append(spec)
            strides.append(prev_stride)
        elif btype == "shortcut":
            idx = cur_index()
            frm = int(block["from"])
            spec = ShortcutSpec(
                from_index=frm if frm >= 0 else frm + idx,
                activation=block.get("activation", "linear"),
            )
            layers.append(spec)
            strides.append(prev_stride)
        elif btype == "yolo":
            mask = [int(s) for s in block["mask"].split(",")]
            vals = [float(s) for s in block["anchors"].split(",")]
            all_anchors = [
                (vals[i], vals[i + 1], math.sin(vals[i + 2]), math.cos(vals[i + 2]))
                for i in range(0, len(vals), 3)
            ]
            spec = YoloSpec(
                anchors=tuple(all_anchors[m] for m in mask),
                num_classes=int(block["classes"]),
                stride=prev_stride,
                scale_x_y=float(block.get("scale_x_y", 1.0)),
                ignore_thresh=float(block.get("ignore_thresh", 0.7)),
            )
            layers.append(spec)
            strides.append(prev_stride)
        elif btype in ("net", "cost"):
            continue
        else:
            raise ValueError(f"unsupported cfg block type: [{btype}]")

    return NetSpec(
        layers=tuple(layers),
        in_channels=in_channels,
        width=width,
        height=height,
        name=name or "cfg_net",
    ).validate()
