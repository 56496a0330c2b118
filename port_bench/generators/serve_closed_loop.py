"""Closed-loop serving of COO requests through the port's `infer_cells`.

One client sends a request, waits for its detections and mask on the host,
and sends the next: a fixed load of one request in flight, so the card is
never idle for want of work and no queue builds. Each request is `batch`
clustered scenes cropped to the BEV boundary and aggregated into flat COO
cells by the benchmark's frozen host code in set-up; a pool of
`pool_requests` requests is served in a seeded order, cycling. The timed
path of a request: the H2D of its COO arrays, the device raster, the
network, the decode and the rotated NMS (`make_inference_fn(from_cells=
True)`), then the D2H of the detections and the mask.

Correctness (decided after the window, the program freed): a sample of
served requests drawn from the seed (a reservoir over the whole window,
plus the pool's request with the most cells). What is judged is what the
entry point returned, each frame's detections and mask, against the
reference's own pipeline from the raw points: its raster, the plain
network (the int8 convs emulated with scales it calibrates itself), its
decode and its NMS. Each served row is scored against the reference's
answer for its frame, its decoded boxes and its NMS's kept rows
(`reference.nms.row_gaps`): its row gap, the distance to the nearest
reference box or kept row in the units of the head's output (the box,
conf, and the logit of the served class's conf against the reference's
logit of that class), and its score gap, how far the reference's score of
the box nearest in geometry lies below the reference's k-th best (a
served row is one of the k best candidates its NMS ranked). Compared:
- `frame_row_gap`: the worst frame's median row gap over its clean rows,
  those nearest a box that the reference NMS merged with no other, among
  the frames with at least k/4 clean rows. Rounding moves a served row a
  little off its reference box; a frame served with another frame's
  heads, or with heads a broken layer made, or rows that name a class
  their conf does not belong to, move most of them. A merged row is the
  mean of its group, and which needles join a group turns on rounding,
  so merged rows are judged by their score alone; a frame that keeps a
  dozen rows, most of them merged, has too few clean ones for a median.
- `frame_score_gap`: the worst frame's median score gap: the NMS's
  candidates are the k best of the frame, not any boxes.
The kept sets are not compared as sets: at these seeded weights the
boxes are needles whose overlap swings with one rounding step of yaw, and
the top k of some 13,000 candidates reshuffle under int8 rounding, so two
right answers keep and merge different boxes at the margin.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List

import numpy as np

from .. import harness
from ..frozen import scenes, weights as frozen_weights, work
from ..reference import darknet, nms as ref_nms, raster as ref_raster

SPAN = "port_bench.span."


class Inputs:
    """The seeded pool of requests and the calibration frames."""

    def __init__(self, traffic: dict, seed: int):
        b, p = traffic["batch"], traffic["pool_requests"]
        sc = traffic["scenes"]
        jobs = [(seed, "pool", i, sc["clustered"], sc["max_objects"], True)
                for i in range(p * b)]
        jobs += [(seed, "calib", j, sc["clustered"], sc["max_objects"], False)
                 for j in range(traffic["calibration_frames"])]
        made = scenes.make_scenes(jobs, workers=min(8, os.cpu_count() or 1))
        self.clouds = [[made[r * b + j][0] for j in range(b)] for r in range(p)]
        self.calib_clouds = [m[0] for m in made[p * b:]]
        self.coo = []
        self.cells = []
        for r in range(p):
            cells, keys = zip(*(made[r * b + j][1] for j in range(b)))
            self.cells.append(sum(len(c) for c in cells))
            self.coo.append(scenes.pack_cells_flat(cells, keys, traffic["coo_capacity"]))
        self.order = np.random.default_rng((int(seed), 7)).permutation(p)


def calib_at(torch, cfg: dict, inputs: Inputs, dev):
    """The calibration rasters (the reference's raster of the calibration
    clouds) at the configuration's input size, on `dev`."""
    return darknet.resize(ref_raster.raster(inputs.calib_clouds, dev), cfg["img_size"])


def make_weights(torch, cfg: dict, seed: int, inputs: Inputs, dev) -> Dict[int, tuple]:
    """Sighted, BN-folded f32 weights on the device, from the seed."""
    params = frozen_weights.init_params(cfg["layers"], seed, dev)
    return frozen_weights.sighted_folded(cfg["layers"], params,
                                         calib_at(torch, cfg, inputs, dev)[:1])


def build_program(torch, cfg: dict, traffic: dict, folded: Dict[int, tuple],
                  inputs: Inputs, dev):
    """The port's served model for the cell's path: `Darknet` in bf16, int8
    PTQ of the configuration's frozen int8 set (the port's `quantize_model`,
    calibrated on the calibration rasters), fused CSP stages on request."""
    from complex_yolov4_tpu_torch.models import quantize, weights, zoo
    from complex_yolov4_tpu_torch.models.network import Darknet

    size = cfg["img_size"]
    spec = zoo.get_model_spec(cfg["model"], num_classes=cfg["num_classes"],
                              width=size, height=size)
    if harness.layers_of(spec) != cfg["layers"]:
        raise RuntimeError(f"the port's {cfg['model']} differs from the frozen layers "
                           f"of configuration {cfg['name']}")
    path = traffic["path"]
    state = {}
    for i, (w, b) in folded.items():
        state[f"layer{i}.weight"] = w
        state[f"layer{i}.bias"] = b
    quant = None
    if path["int8"]:
        tree = {f"layer{i}": {"w": w.permute(2, 3, 1, 0).cpu().numpy(), "b": b.cpu().numpy()}
                for i, (w, b) in folded.items()}
        skip = set(folded) - set(cfg["int8_layers"])
        calib = calib_at(torch, cfg, inputs, dev).cpu().numpy()
        qtree = quantize.quantize_model(spec, tree, [calib], device=dev, skip=skip)
        if sorted(int(k[len("layer"):]) for k in qtree) != sorted(cfg["int8_layers"]):
            raise RuntimeError("the port quantized another layer set than the configuration's")
        quant = weights.from_jax_quant(spec, qtree)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[path["compute_dtype"]]
    model = Darknet(spec, state, compute_dtype=dtype, device=dev, quant=quant,
                    fused_stages=path["fused_stages"])
    return model


class ProgramServer:
    """The port's serving call: the entry point and nothing around it."""

    def __init__(self, torch, model, inputs: Inputs, traffic: dict):
        from complex_yolov4_tpu_torch.evaluation import evaluator

        self.model = model
        self.inputs = inputs
        self.batch = traffic["batch"]
        n = traffic["nms"]
        self.infer = evaluator.make_inference_fn(
            conf_thresh=n["conf_thresh"], nms_thresh=n["nms_thresh"], max_boxes=n["max_boxes"],
            from_cells=True, img_size=int(model.spec.width))

    def serve(self, r: int):
        cells, keys, dens = self.inputs.coo[r]
        dets, masks = self.infer(self.model, cells, keys, dens, self.batch)
        return dets.cpu(), masks.cpu()

    def close(self):
        self.model = self.infer = None


class ControlServer:
    """The reference in the program's place, one precision down: fp8 (e4m3)
    for the bf16 convs, int4 for the int8 ones, and the NMS on bf16-rounded
    rows. Used by `limits.py` and the tests, never by a benchmark run."""

    def __init__(self, torch, cell: harness.Cell, folded, inputs: Inputs, dev):
        self.torch = torch
        self.cfg, self.traffic, self.inputs, self.dev = cell.config, cell.traffic, inputs, dev
        self.ref = reference(torch, cell, folded, inputs, dev, control=True)

    def serve(self, r: int):
        torch = self.torch
        img = ref_raster.raster(self.inputs.clouds[r], self.dev)
        decoded = self.ref.decoded(img, self.cfg["img_size"])
        low = decoded.to(torch.bfloat16).float().cpu().numpy()
        n = self.traffic["nms"]
        k = n["max_boxes"]
        dets = torch.zeros((len(low), k, 9))
        masks = torch.zeros((len(low), k))
        for b, (rows, _, _) in enumerate(ref_nms.nms(low, n["conf_thresh"], n["nms_thresh"], k)):
            dets[b, :len(rows)] = torch.as_tensor(rows, dtype=torch.float32).to(torch.bfloat16)
            masks[b, :len(rows)] = 1.0
        return dets, masks

    def close(self):
        self.ref = None


def reference(torch, cell: harness.Cell, folded, inputs: Inputs, dev,
              control: bool = False) -> darknet.Reference:
    """The plain network of the cell in its compute dtype: int8 convs
    emulated with scales it calibrates on the calibration rasters in that
    dtype; the control one precision down."""
    cfg, traffic = cell.config, cell.traffic
    q = list(cfg["int8_layers"]) if traffic["path"]["int8"] else []
    dtype = getattr(torch, traffic["path"]["compute_dtype"])
    calib = calib_at(torch, cfg, inputs, dev)
    act_max = darknet.calibrate(cfg["layers"], folded, calib, q, dtype) if q else {}
    del calib
    if control:
        modes = {i: ("int4" if i in q else "fp8") for i in folded}
    else:
        modes = {i: "int8" for i in q}
    return darknet.Reference(cfg["layers"], folded, modes, act_max, dtype)


def window(torch, server, inputs: Inputs, seconds: float, seed: int, keep: int) -> dict:
    """The measured window: requests back to back until `seconds` have
    passed, the last one finished. Keeps a reservoir of `keep` served
    requests drawn from the seed, plus the last serving of the pool's
    request with the most cells."""
    rng = np.random.default_rng((int(seed), 11))
    largest = int(np.argmax(inputs.cells))
    order = inputs.order
    sample: List[tuple] = []
    last_largest = None
    lat: List[float] = []
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t1 = t_start
    while t1 < deadline:
        r = int(order[n % len(order)])
        t0 = time.perf_counter()
        dets, masks = server.serve(r)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        item = (r, dets, masks)
        if n < keep:
            sample.append(item)
        else:
            j = int(rng.integers(0, n + 1))
            if j < keep:
                sample[j] = item
        if r == largest:
            last_largest = item
        n += 1
    if last_largest is not None and all(s[0] != largest for s in sample):
        sample.append(last_largest)
    return {"requests": n, "seconds": t1 - t_start, "latencies": lat, "sample": sample}


def check(torch, cfg: dict, traffic: dict, ref: darknet.Reference, inputs: Inputs,
          sample: List[tuple], dev) -> Dict[str, float]:
    """The compared numbers over the sampled requests (module docstring)."""
    size = cfg["img_size"]
    n = traffic["nms"]
    stride = ref_nms.box_strides(cfg["layers"], size, dev)
    row_gap = score_gap = 0.0
    rows = clean_rows = frames = judged = 0
    worst = ""
    min_clean = n["max_boxes"] // 4
    log = harness.PhaseLog(time.perf_counter())
    for r, dets, masks in sample:
        decoded = ref.decoded(ref_raster.raster(inputs.clouds[r], dev), size)
        log.add("reference pipeline")
        answers = ref_nms.nms(decoded.cpu().numpy(), n["conf_thresh"], n["nms_thresh"],
                              n["max_boxes"])
        log.add("reference NMS")
        for b, answer in enumerate(answers):
            served = dets[b][masks[b] > 0.5].to(dev)
            if len(served) == 0:
                continue
            gaps, clean, scores = ref_nms.row_gaps(served, decoded[b], stride,
                                                   n["conf_thresh"], n["max_boxes"], *answer)
            frames += 1
            if int(clean.sum()) >= min_clean:
                judged += 1
                if float(gaps[clean].median()) > row_gap:
                    row_gap = float(gaps[clean].median())
                    worst = (f"request {r} frame {b}: {int(clean.sum())} clean of "
                             f"{len(served)} served rows, {len(answer[0])} kept by the reference")
            score_gap = max(score_gap, float(scores.median()))
            rows += len(gaps)
            clean_rows += int(clean.sum())
        log.add("row gaps")
    log.totals()
    print(f"[port_bench] check: {rows} rows, {clean_rows} clean; {judged} of {frames} frames "
          f"with {min_clean} clean rows or more; worst frame_row_gap in {worst or 'no frame'}",
          file=sys.stderr, flush=True)
    return {"frame_row_gap": row_gap, "frame_score_gap": score_gap}


def trace_record(torch, cell: harness.Cell, server: ProgramServer, inputs: Inputs,
                 stats: dict) -> dict:
    """The per-layer record of a --trace 1 run, taken after the window on
    the same model: host-clock NMS, then one profiler trace that holds
    (a) each pool request's H2D and raster, and its network, each in a
    range of its own that ends on a synchronize; (b) the prefix forwards
    of the layer ranges on request 0's raster; (c) one pass over the pool
    served as in the window. The spans' and prefixes' device times are the
    busy time of the card inside their ranges; they come from a synced
    pass, not from the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from complex_yolov4_tpu_torch.data import bev
    from complex_yolov4_tpu_torch.ops.nms import nms_batch

    cfg, traffic = cell.config, cell.traffic
    model, batch, dev = server.model, traffic["batch"], server.model.device
    n = traffic["nms"]
    cuda = torch.cuda

    def raster(r):
        cells, keys, dens = (torch.as_tensor(x, device=dev) for x in inputs.coo[r])
        return bev.make_bev_map_from_cells(cells, keys, dens, batch).permute(0, 3, 1, 2)

    with torch.inference_mode():
        # NMS alone on each request's decoded heads, host clock, synced
        decoded = [model(raster(r)) for r in range(len(inputs.coo))]
        calls, t0 = 0, time.perf_counter()
        while calls < 2 * len(decoded) or time.perf_counter() - t0 < 0.25:
            nms_batch(decoded[calls % len(decoded)], n["conf_thresh"], n["nms_thresh"],
                      n["max_boxes"])
            cuda.synchronize()
            calls += 1
        nms_ms = (time.perf_counter() - t0) * 1e3 / calls
        del decoded
        x = raster(0)
        # the prefix forwards that bound each layer range: stop_after values
        stops = {"full": None}
        for first, last in cfg["ranges"].values():
            if first > 0:
                stops[str(first - 1)] = first - 1
            if last is not None:
                stops[str(last)] = last
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for rep in range(2):  # the first pass warms the path under the profiler
                for r in range(len(inputs.coo)):
                    with record_function(f"{SPAN}raster" if rep else "warm"):
                        img = raster(r)
                        cuda.synchronize()
                    with record_function(f"{SPAN}network" if rep else "warm"):
                        model(img)
                        cuda.synchronize()
            for key, stop in stops.items():
                model(x, stop_after=stop)
                cuda.synchronize()
                with record_function(f"{SPAN}upto.{key}"):
                    for _ in range(reps):
                        model(x, stop_after=stop)
                    cuda.synchronize()
            # one served pass over the pool as in the window, after a warm one
            for r in range(len(inputs.coo)):
                server.serve(r)
            cuda.synchronize()
            with record_function(harness.TRACE_MARK):
                for r in range(len(inputs.coo)):
                    server.serve(r)
                cuda.synchronize()
    events = prof.events()
    busy = harness.range_busy(events, DeviceType.CUDA, SPAN)
    tl = harness.timeline(events, DeviceType.CUDA)
    tl["items"] = len(inputs.coo)
    upto = {k: float(np.mean(v)) * 1e3 / reps for k, v in busy.items() if k.startswith("upto.")}
    int8 = cfg["int8_layers"] if traffic["path"]["int8"] else []
    ranges = {}
    for name, (first, last) in cfg["ranges"].items():
        before = upto.get(f"upto.{first - 1}", 0.0) if first > 0 else 0.0
        until = upto.get("upto.full" if last is None else f"upto.{last}")
        if until is None:
            continue
        bound = work.range_bound_s(cfg["layers"], cfg["img_size"], batch, int8, first, last)
        ranges[name] = {"device_ms": until - before, "bound_ms": bound * 1e3}
    spans = {"nms_ms": nms_ms}
    for name in ("raster", "network"):
        if busy.get(name):
            spans[f"{name}_ms"] = float(np.mean(busy[name])) * 1e3
    return {
        "kind": "serve",
        "spans": spans,
        "ranges": ranges,
        "window": {"items_per_s": stats["requests"] * batch / stats["seconds"]},
        "peak_s_per_item": work.peak_seconds_per_frame(cfg["layers"], cfg["img_size"], int8),
        "trace": tl,
    }


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(torch, cell: harness.Cell, seed: int, seconds: float, trace: bool, t_begin: float,
        dev=None):
    """One run of the cell: set-up, the window, then the check (and the
    trace record). Returns (the result's attempted, metrics, device and
    trace fields; the compared numbers; the requests checked)."""
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    log = harness.PhaseLog(t_begin)
    log("imports and the card")
    inputs = Inputs(traffic, seed)
    log("scenes and COO")
    folded = make_weights(torch, cfg, seed, inputs, dev)
    log("weights")
    model = build_program(torch, cfg, traffic, folded, inputs, dev)
    log("program")
    server = ProgramServer(torch, model, inputs, traffic)
    for r in range(len(inputs.coo)):  # warm every shape the window serves
        server.serve(r)
    sync(torch, dev)
    # set-up's objects leave the collector's generations: a full collection
    # in the window then walks only what the window made
    gc.collect()
    gc.freeze()
    log("warm-up")
    setup_s = time.perf_counter() - t_begin
    watch = harness.WindowWatch(dev.type == "cuda")
    stats = window(torch, server, inputs, seconds, seed, traffic["check_requests"])
    watch.report(stats["seconds"])
    log(f"window: {stats['requests']} requests")
    device = harness.card(torch, dev)
    metrics: Dict[str, dict] = {}
    result = {"attempted": stats["requests"], "metrics": metrics, "device": device}
    if trace:
        record = trace_record(torch, cell, server, inputs, stats)
        record["power_limit"] = harness.power_limit()
        log("trace record")
        device.update(busy_s=record["trace"].get("busy_s", 0.0),
                      window_s=record["trace"].get("window_s", 0.0))
        for m in cell.per_layer():
            value = harness.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if record["trace"].get("device_ops"):
            result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                                   "idle_gaps": record["trace"]["idle_gaps"]}
        result["card"] = record["power_limit"]
    else:
        frames = stats["requests"] * traffic["batch"]
        values = {"frames_per_s": frames / stats["seconds"],
                  "request_p95_ms": harness.quantile(stats["latencies"], 0.95) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    sample = stats.pop("sample")
    server.close()
    del model, server
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(torch, cell, folded, inputs, dev)
    numbers = check(torch, cfg, traffic, ref, inputs, sample, dev)
    log(f"check of {len(sample)} requests")
    return result, numbers, len(sample)


def limit_readings(torch, cell: harness.Cell, seeds, control_seeds, seconds: float,
                   dev=None):
    """Yields (who, seed, numbers): the compared numbers of sound runs of
    the program (who "program", a `seconds` window each) and of the control
    in its place (who "control", one pass over the pool), in one process.
    The readings `limits.py` prints, that the cell's limits are set from."""
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    for who, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            inputs = Inputs(traffic, seed)
            folded = make_weights(torch, cfg, seed, inputs, dev)
            if who == "program":
                server = ProgramServer(torch, build_program(torch, cfg, traffic, folded,
                                                            inputs, dev), inputs, traffic)
                for r in range(len(inputs.coo)):
                    server.serve(r)
                sample = window(torch, server, inputs, seconds, seed,
                                traffic["check_requests"])["sample"]
            else:  # every pool request once
                server = ControlServer(torch, cell, folded, inputs, dev)
                sample = [(r, *server.serve(r)) for r in range(len(inputs.coo))]
            server.close()
            ref = reference(torch, cell, folded, inputs, dev)
            yield who, seed, check(torch, cfg, traffic, ref, inputs, sample, dev)
            del server, ref, sample, folded
            if dev.type == "cuda":
                torch.cuda.empty_cache()
