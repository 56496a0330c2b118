"""Serving A/B between two checkouts of the PyTorch/CUDA port, in one
process on one GPU.

    python3 serve_ab.py PARENT_CHECKOUT

imports the port beside this script ("change") and the port of
PARENT_CHECKOUT under another name ("parent"), and serves path 1 of
chip_smoke.py phase 4 through each one's own `make_inference_fn(
from_cells=True)`: complex_yolov4 @608, bf16, seed-0 weights, REQUESTS
requests of BATCH synthetic scenes as flat COO built by numpy, conf 0.5,
nms 0.5, k=64. Each measurement runs in turns, parent, change, change,
parent, REPS times, after a warm-up of both:

- `device_ms`: the mean device part of a request (raster .. NMS, synced,
  host clock), as phase 4 prints it, through each arm's own function: a
  checkout that serves COO cells from a CUDA graph runs a request's key
  eager in the warm-up, captures it in the first turn and replays it
  after (the first turn's readings hold the capture: read the medians);
- `nms_ms`: the mean `nms_batch` alone on each request's decoded heads
  (synced), the same heads for both;
- `stem_us`, `conv3x3_us`: the host's microseconds per call of the stem and
  3x3 wrappers at the main-path shapes of layers 0 and 6 (the enqueue of
  CALLS calls, no sync between them: each call's host cost, the kernel's
  time left out while the launch queue has room).

It prints one JSON line with every arm's readings, their means and
medians, the median over turns of the change's readings over the
parent's in the same turn (`paired_median_ratio`), and the card's name
and power limit. Each checkout builds its
kernels from its own sources. Exits 1 without CUDA.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, REQUESTS, REPS, CALLS = 8, 8, 10, 50


def load_package(name: str, checkout: str):
    """The port package of `checkout`, imported as `name`."""
    pkg = os.path.join(os.path.abspath(checkout), "complex_yolov4_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Arm:
    """One checkout's serving path: its modules, model and inference fn."""

    def __init__(self, name: str, dev: torch.device):
        sub = {m: importlib.import_module(f"{name}.{m}") for m in (
            "data.bev", "data.synthetic", "evaluation.evaluator", "models.weights",
            "models.zoo", "models.network", "ops.conv3x3", "ops.stem_conv", "ops.nms")}
        self.bev, self.ops = sub["data.bev"], sub
        w, zoo = sub["models.weights"], sub["models.zoo"]
        spec = zoo.get_model_spec("complex_yolov4")
        params, state = w.init_params_np(spec, 0)
        self.model = sub["models.network"].Darknet(
            spec, w.from_folded(spec, w.fold_batchnorm(spec, params, state)),
            compute_dtype=torch.bfloat16, device=dev)
        self.infer = sub["evaluation.evaluator"].make_inference_fn(
            conf_thresh=0.5, nms_thresh=0.5, max_boxes=64, from_cells=True)
        self.nms = sub["ops.nms"].nms_batch
        self.stem = sub["ops.stem_conv"].conv3x3_stem
        self.conv = sub["ops.conv3x3"].conv3x3_fused


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host_us(call) -> float:
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / CALLS * 1e6


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit("usage: python3 serve_ab.py PARENT_CHECKOUT")
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    load_package("parent_port", sys.argv[1])
    arms = {"parent": Arm("parent_port", dev), "change": Arm("complex_yolov4_tpu_torch", dev)}
    bev, synthetic = arms["change"].bev, arms["change"].ops["data.synthetic"]

    def request(r):
        clouds = [bev.remove_points_outside(synthetic.sample_scene(
            np.random.default_rng(1000 * (r + 1) + b))[0]) for b in range(BATCH)]
        cells_l, keys_l = zip(*map(bev.aggregate_bev_cells, clouds))
        total = sum(len(c) for c in cells_l)
        return bev.pack_cells_flat(list(cells_l), list(keys_l), total + total // 8)

    reqs = [request(r) for r in range(REQUESTS)]
    with torch.inference_mode():
        decoded = []
        for req in reqs:
            cells, keys, dens = (torch.as_tensor(a, device=dev) for a in req)
            img = bev.make_bev_map_from_cells(cells, keys, dens, BATCH)
            decoded.append(arms["change"].model(img.permute(0, 3, 1, 2)))
        x0 = torch.rand((BATCH, 608, 608, 3), device=dev)
        x6 = torch.rand((BATCH, 304, 304, 32), device=dev).to(torch.bfloat16)

    def measure(arm: Arm):
        m = arm.model
        with torch.inference_mode():
            dev_ms = float(np.mean([synced_ms(lambda q=q: arm.infer(m, *q, BATCH))
                                    for q in reqs]))
            nms_ms = float(np.mean([synced_ms(lambda d=d: arm.nms(d, 0.5, 0.5, 64))
                                    for d in decoded]))
            stem = host_us(lambda: arm.stem(x0, m.wk0, m.bk0, activation="mish"))
            conv = host_us(lambda: arm.conv(x6, m.wk6, m.bk6, stride=1, activation="mish"))
        return {"device_ms": dev_ms, "nms_ms": nms_ms, "stem_us": stem, "conv3x3_us": conv}

    for arm in arms.values():  # warm-up
        measure(arm)
    readings = {name: [] for name in arms}
    for _ in range(REPS):
        for name in ("parent", "change", "change", "parent"):
            readings[name].append(measure(arms[name]))
    out = {"card": smi, "parent": sys.argv[1], "readings": readings}
    for stat, fn in (("means", np.mean), ("medians", np.median)):
        out[stat] = {name: {k: float(fn([r[k] for r in rs])) for k in rs[0]}
                     for name, rs in readings.items()}
    # paired: in each turn the change's two readings over the parent's two
    par, chg = readings["parent"], readings["change"]
    out["paired_median_ratio"] = {
        k: float(np.median([(chg[2 * i][k] + chg[2 * i + 1][k])
                            / (par[2 * i][k] + par[2 * i + 1][k]) for i in range(REPS)]))
        for k in par[0]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
