"""Typed runtime configuration for the port's evaluation CLI.

A copy of `EvalConfig`, `_add_fields`, `_build` and `parse_eval_config` from
`complex_yolov4_tpu/config/runtime.py` (reference: src/evaluate.py:67-105):
the same flag names and defaults, plus one field of the port's, `device`
(``--device``, default ``cuda``; ``cpu`` runs the kernels' plain versions).
`tests/test_torch_port_copies.py` holds the copy equal to the original.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class EvalConfig:
    saved_fn: str = "complexer_yolo"
    working_dir: str = "./workdir"
    dataset_dir: str = "./dataset/kitti"
    model: str = "complex_yolov4"
    cfgfile: Optional[str] = None
    pretrained_path: Optional[str] = None
    img_size: int = 608
    batch_size: int = 4
    num_samples: Optional[int] = None
    conf_thresh: float = 0.5
    nms_thresh: float = 0.5
    iou_thresh: float = 0.5
    synthetic: bool = False
    synthetic_frames: int = 8
    compute_dtype: str = "float32"
    quantize: str = "none"                   # "none" | "int8" (PTQ, models/quantize.py)
    calib_batches: int = 2                   # calibration batches for --quantize int8
    host_raster: bool = False                # force host-side BEV rasterization
    cells_raster: bool = False               # host-aggregated COO raster
                                             # (single-device serving; the
                                             # bench-default layout)
    device: str = "cuda"                     # the port's: "cuda" or "cpu"


def _add_fields(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        if f.type in ("bool", bool) or isinstance(f.default, bool):
            parser.add_argument(name, action="store_true", default=f.default)
        elif f.name == "steps":
            parser.add_argument(name, nargs=2, type=int, default=list(f.default))
        else:
            typ = type(f.default) if f.default is not None else str
            if typ is type(None):
                typ = str
            parser.add_argument(name, type=typ, default=f.default)


def _build(cls, argv=None):
    parser = argparse.ArgumentParser(description=cls.__name__)
    _add_fields(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)}
    if "steps" in kwargs:
        kwargs["steps"] = tuple(kwargs["steps"])
    # optional ints arrive as strings from argparse when default is None
    if kwargs.get("num_samples") is not None:
        kwargs["num_samples"] = int(kwargs["num_samples"])
    return cls(**kwargs)


def parse_eval_config(argv=None) -> EvalConfig:
    return _build(EvalConfig, argv)
