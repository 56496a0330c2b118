"""Model export CLI of the port: deployment artifacts from a checkpoint.

Counterpart of `complex_yolov4_tpu/cli/export.py`: the same flags, plus
``--device`` (default ``cuda``; raises without CUDA unless ``--device
cpu``). Formats:

- `pt2` (the default; the counterpart of `stablehlo`): the serving program
  (BN folded, bf16 compute, forward + decode + rotated NMS) traced by
  `torch.export` and written with `torch.export.save`. The hand kernels are
  nodes of the graph as the custom ops ``cyv4::stem_conv3x3``,
  ``cyv4::conv3x3`` and, with ``FUSED_STAGE=1``, ``cyv4::fused_stage``; the
  NMS fixpoint is one `while_loop` node. The input signature is static:
  ``--batch`` x ``--img_size`` rasters, or with ``--input points``
  ``--max_points`` padded points a frame and their mask, rastered at the
  native 608 and resized inside the program. It differs from the JAX
  artifact in three ways: the `.pt2` carries its bf16 weights (JAX's takes
  them as arguments); loading it needs ``import complex_yolov4_tpu_torch.ops``
  first, which registers the ops; and the CUDA kernels are built at their
  first launch in the loading process. The kernel routes are fixed when
  the program is traced, for the device it was traced on: export on the
  card for serving on the card.
- `darknet`: reference-compatible `.weights` binary.
- `ckpt` (the counterpart of `orbax`): the parameters and BN statistics as
  a `.ckpt` file that ``--pretrained_path`` reads.

`stablehlo` and `orbax` raise, naming the port's counterpart.

Usage (on the CPU):
    python -m complex_yolov4_tpu_torch.cli.export --model complex_yolov4_tiny \\
        --img_size 128 --output model.pt2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional

import torch
from torch import nn

from ..data import bev
from ..models import weights
from ..models import weights_io as wio
from ..models.network import Darknet
from ..ops.nms import nms_batch
from ..train.checkpoint import save_params_and_bn
from . import common

COUNTERPARTS = {"stablehlo": "pt2", "orbax": "ckpt"}


class ServingProgram(nn.Module):
    """The exported function: rasters (B, S, S, 3) f32, or with
    ``from_points`` padded points (B, P, 4) and their mask (B, P), ->
    (detections (B, max_boxes, 9), masks (B, max_boxes)), as
    `make_inference_fn` serves them (no flip, no cutout holes)."""

    def __init__(self, model: Darknet, *, from_points: bool, img_size: int,
                 conf_thresh: float, nms_thresh: float, max_boxes: int):
        super().__init__()
        self.model = model
        self.from_points = from_points
        self.img_size = img_size
        self.conf_thresh, self.nms_thresh, self.max_boxes = conf_thresh, nms_thresh, max_boxes

    def forward(self, *inputs: torch.Tensor):
        if self.from_points:
            points, pmask = inputs
            b = points.shape[0]
            images = bev.images_from_deferred_batch(
                {"points": points, "point_mask": pmask,
                 "flip": points.new_zeros((b,)), "holes": points.new_zeros((b, 0, 5)),
                 "hole_mask": points.new_zeros((b, 0))}, self.img_size)
        else:
            images = inputs[0]
        decoded = self.model(images.permute(0, 3, 1, 2))  # NCHW view, channels_last
        return nms_batch(decoded, self.conf_thresh, self.nms_thresh, self.max_boxes)


def serving_model(spec, params, state, device: torch.device, img_size: int) -> Darknet:
    """The bf16 serving `Darknet`, BN folded, its fused segments
    (``FUSED_STAGE=1``) and kernel routes at `img_size` planned now: the
    trace then reads them as constants."""
    fused = os.environ.get("FUSED_STAGE", "") == "1"
    model = Darknet(spec, weights.from_folded(spec, weights.fold_batchnorm(spec, params, state)),
                    compute_dtype=torch.bfloat16, device=device, fused_stages=fused)
    model.routes(img_size, fused=bool(model.segments(img_size)))
    return model


def export_pt2(spec, params, state, output: str, *, device: torch.device, batch: int,
               img_size: int, conf_thresh: float, nms_thresh: float, max_boxes: int,
               input_kind: str = "image", max_points: int = 20480) -> Dict[str, float]:
    """Trace and save the serving program; returns the seconds of each step
    and the file's MB."""
    model = serving_model(spec, params, state, device, img_size)
    prog = ServingProgram(model, from_points=input_kind == "points", img_size=img_size,
                          conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                          max_boxes=max_boxes).eval()
    if input_kind == "points":
        args = (torch.zeros((batch, max_points, 4), device=device),
                torch.zeros((batch, max_points), device=device))
    else:
        args = (torch.zeros((batch, img_size, img_size, 3), device=device),)
    t0 = time.perf_counter()
    with torch.no_grad():
        exported = torch.export.export(prog, args)
    t1 = time.perf_counter()
    exported.example_inputs = None  # the file keeps no zero inputs
    torch.export.save(exported, output)
    t2 = time.perf_counter()
    size = os.path.getsize(output)
    print(f"wrote torch.export artifact ({size} bytes) -> {output}")
    return {"export_s": t1 - t0, "save_s": t2 - t1, "mb": size / 2 ** 20}


def round_trip(output: str, input_kind: str, device: torch.device) -> float:
    """Load the artifact back (the counterpart of `jexport.deserialize`) and
    print what it holds; returns the load's seconds."""
    t0 = time.perf_counter()
    restored = torch.export.load(output)
    load_s = time.perf_counter() - t0
    sig = restored.call_spec.in_spec.num_leaves if restored.call_spec.in_spec else 0
    kernels = sorted({str(n.target) for n in restored.graph.nodes
                      if str(n.target).startswith("cyv4.")})
    print(f"  round trip: {sig} input leaves ({input_kind}), device {device}, "
          f"custom ops {kernels}")
    return load_s


def write_weights(fmt: str, spec, params, state, output: str) -> None:
    """--format darknet (a reference `.weights` file) or ckpt (a `.ckpt`
    that --pretrained_path reads)."""
    if fmt == "darknet":
        wio.save_darknet_weights(spec, params, state, output)
        print(f"wrote darknet weights -> {output}")
    else:
        save_params_and_bn(output, params, state)
        print(f"wrote params + BN checkpoint -> {output}")


def main(argv=None) -> Optional[Dict[str, float]]:
    """Run the export; for --format pt2 returns the export, save and load
    seconds and the file's MB."""
    parser = argparse.ArgumentParser("export")
    parser.add_argument("--model", type=str, default="complex_yolov4")
    parser.add_argument("--cfgfile", type=str, default=None)
    parser.add_argument("--pretrained_path", type=str, default=None)
    parser.add_argument("--format", type=str, default="pt2",
                        choices=["pt2", "darknet", "ckpt", "stablehlo", "orbax"])
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--conf_thresh", type=float, default=0.5)
    parser.add_argument("--nms_thresh", type=float, default=0.5)
    parser.add_argument("--max_boxes", type=int, default=128)
    parser.add_argument("--input", type=str, default="image",
                        choices=["image", "points"],
                        help="pt2 input signature: BEV images, or "
                             "padded point clouds (raster inside the artifact)")
    parser.add_argument("--max_points", type=int, default=20480)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    if args.format in COUNTERPARTS:
        raise ValueError(f"--format {args.format} is the JAX package's; the port's "
                         f"counterpart is --format {COUNTERPARTS[args.format]}")

    device = common.resolve_device(args)
    spec = common.resolve_spec(args)
    params, state = common.init_or_load(spec, args.pretrained_path)

    if args.format != "pt2":
        write_weights(args.format, spec, params, state, args.output)
        return None
    t = export_pt2(spec, params, state, args.output, device=device, batch=args.batch,
                   img_size=args.img_size, conf_thresh=args.conf_thresh,
                   nms_thresh=args.nms_thresh, max_boxes=args.max_boxes,
                   input_kind=args.input, max_points=args.max_points)
    t["load_s"] = round_trip(args.output, args.input, device)
    print(f"  export {t['export_s']:.2f} s, save {t['save_s']:.2f} s, "
          f"load {t['load_s']:.2f} s, {t['mb']:.1f} MB")
    return t


if __name__ == "__main__":
    main(sys.argv[1:])
