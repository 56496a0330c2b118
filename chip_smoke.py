"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --split    # also each path's stage split and profile

Phases (any failure raises and the run exits non-zero; there is no CPU
fallback):

1. device — the card's name, count, and `nvidia-smi` name and power limit;
2. build — nvcc builds the kernels from complex_yolov4_tpu_torch/csrc/
   (sm_90a, one nvcc per source, in parallel) and its -Xptxas -v register /
   shared-memory lines are printed;
3. kernel vs plain, each on the same inputs as its plain PyTorch version,
   timed with CUDA events (plain, kernel, kernel, plain):
   - the stem kernel at (8, 608, 608, 3 -> 32) and the 3x3 kernel at the
     five complex_yolov4 main-path shapes (batch 8): at most 1 bf16 ulp
     apart (values below 2^-10 of the tensor's largest, where the f32 sum
     cancels, are held to the ulp of that floor);
   - the 3x3 kernel's f32 instance (f32 x rounded to bf16 as it loads, f32
     out: the contract of `pallas_conv.py` on an f32 x) at the same five
     shapes: within 1e-4 of max |plain| (both round to bf16 the same way;
     only the summation order differs); its library_ms is one f32 cuDNN
     `F.conv2d` with TF32 off, as the port's f32 path runs;
   - the fused-stage kernel at (8, 304, 304, 64) segment 2-10 and (8, 152,
     152, 128) segment 12-23, the segments of complex_yolov4_tiny and
     complex_yolov3, and one 76-px batch-2 case (ragged tiles): max |diff|
     <= 1e-2 * max |plain| (both round to bf16 after every op); the
     main-path segments also print the FLOP the kernel executes (halo
     recompute included) and its rate;
   - the int8 kernel at each distinct (k, stride, C_in, C_out, H, input
     dtype) of the 68 quantized convs of complex_yolov4 at 608, batch 8,
     with the input path 2 gives it (int8 from a chained producer, else
     bf16, quantized in the kernel): int32 sums equal, bf16 outputs within
     1 ulp, requantized int8 within 1, f32 outputs (f32 compute) within
     1e-5 of max |plain| (the fast exp and divide); beside each eager
     kernel_ms, its device time (`device_ms`: CUDA-graph replay, no host
     launch cost), and the times of the modes f32 compute runs: an int8
     input (f32 compute quantizes every conv's input before the call),
     int8 out on the chained convs and f32 out on the rest;
   every timed shape also prints two yardsticks beside kernel_ms:
   - bound_ms, the least time the card could take for the same work: the
     larger of its bytes (each input read once, each output written once)
     over 3.35 TB/s and its operations over the bf16 or int8 tensor-core
     peak, from the shapes (`bound_ms`); kernel_ms / bound_ms is how far
     the kernel is from the card's limit;
   - library_ms, one PyTorch call computing the same function where there
     is one: for the stem and the 3x3 kernel one cuDNN `F.conv2d` (bf16,
     channels_last input and weight, bias, no activation, autotuned for
     that timing only); for the int8 conv's 1x1 layers one `torch._int_mm`
     (int8 -> int32 sums, no dequantization, bias or activation), summed
     over those layers only and printed beside the kernel's time on them;
     null, with the reason printed, for the int8 3x3 layers and the fused
     stage, which no single PyTorch call computes. A kernel slower than
     library_ms loses to the library. The port never calls it;
4. slice — complex_yolov4 at 608, full width, bf16, random weights from
   seed 0, serves 8 requests of 8 raw synthetic scenes through the port's
   `make_inference_fn(from_cells=True)` (host crop and COO aggregation,
   device raster, network, decode, rotated NMS at k=64, conf 0.5, nms
   0.5), on two paths, each with the launch counts set to 0 just before
   it. Every request is served twice, its COO built once by numpy and once
   by the native library (phase 7 (c); the order alternates, the packed
   arrays must be equal), and each prints its measured e2e frames/s:
   - path 1, bf16: the stem kernel must launch once and the 3x3 kernel
     five times per request;
   - path 2, int8 PTQ (`default_skip`, calibrated on 2 synthetic frames)
     with both fused CSP stages: stem 1, 3x3 2, fused stage 2 and int8
     conv 68 launches per request;
   on each path the decoded heads of the kernel path are compared with the
   all-plain path on the card (path 2 at batch 2: the plain int8 convs run
   in float64);
5. evaluate — a synthetic KITTI tree of 16 val frames (the port's
   `generate_kitti_dataset`, in a temporary directory) evaluated by the
   port's `cli.evaluate.main` (complex_yolov4 @608, batch 8, bf16, conf
   0.45, NMS k=256, rotated-IoU mAP) in four configurations, each with the
   launch counts set to 0 just before it: points (the default: the loader
   ships padded points, the card rasters them), `--cells_raster` (host COO
   aggregation), `--host_raster` (host-rastered images), and `--quantize
   int8 --calib_batches 1` with FUSED_STAGE=1 (path 2). Checks: the kernel
   launches per batch are those `model.routes(608)` predicts (int8: stem 1,
   3x3 2, fused stage 2, int8 conv 68; plus its calibration batch's stem 1
   and 3x3 5); the card's points raster of one batch is within the
   packed-mode budget of the host raster of the same frames; the val
   targets fed as detections (conf 1) through `sample_statistics` on the
   card give AP 1.0 for every class present; on one batch (2 frames) of each
   configuration the decoded heads of the kernel path match the all-plain
   path; every configuration keeps live detections after NMS. Prints per
   configuration the mAP, the live detections, the loader's host ms per
   batch (alone, no prefetch; the cells layout's capacity estimate timed
   apart), and the device ms per batch (raster -> NMS, synced) and eval
   frames/s of the CLI's run (cold: its first batch pays first-use costs)
   and of a second `evaluate_map` pass on the same model (warm).
6. train — a synthetic KITTI tree (16 train, 24 val frames) trained by the
   port's `cli.train.main`: complex_yolov4 @608, bf16, batch 4,
   `--subdivisions 2` (4 micro-batches, 2 optimizer steps), TrainConfig's
   other defaults (Adam, cosine LR, hflip 0.5, device raster from points),
   one epoch with its validation in f32 and one checkpoint, the launch
   counts set to 0 just before: training launches no kernel, validation
   the 3x3 kernel's f32 instance as `model.routes(608)` of the f32 model
   predicts. Then the checkpoint is served by `cli.evaluate.main` with its
   default f32 compute (the weights checked equal to the trained module's,
   the launches as predicted, the decoded heads of 2 frames within 1e-3 of
   the all-plain f32 path, and f32 eval frames/s of a warm pass over 3 batches
   of 8, the first left out), and again, on its first 8 frames, with
   `--quantize int8` in f32 compute (calibrated in f32; the int8 convs
   write f32, or int8 where chained, 68 int8 launches per batch). Then, on the trained state: 12
   steps on one fixed batch (the loss finite and lower after them than
   before), and train images/s over 3 windows of 8 synced steps (each
   window printed), the device's busy share of 3 profiled steps
   (torch.profiler), a forward / loss / backward / optimizer split
   (synced stages of 3 further steps) and the peak memory.
7. host and test — (a) g++ builds the native host rasterizer
   (complex_yolov4_tpu_torch/native/, beside nvcc in phase 2; any failure
   fails the run, there is no numpy fallback here); (b) on phase 5's 16
   frames its `rasterize_points`, `aggregate_cells` and `rasterize_files`
   equal the numpy `make_bev_map`, `aggregate_bev_cells` and per-frame
   rasters bit for bit; (c) runs inside phase 4: each request served
   with its COO built by numpy and by the native library, their host COO
   ms and measured e2e frames/s side by side; (d) the fused native
   mosaic within 1e-6 of the numpy canvas after `resize_linear` (and how
   many are bit-equal), with equal targets and RNG state, for 3 (seed,
   index) pairs; (e) `cli.train.main --mosaic` on 48 train frames of their
   own (complex_yolov4 @608 bf16, batch 4, --subdivisions 2, no
   validation; 12 micro-batches), the launch counts set to 0 just before
   (training launches none): losses finite, iteration and loader-wait ms,
   train images/s over the 10 micro-batches after the profiled one, and
   the mosaic loader's host ms alone; (f) on that run's state and one
   mosaic batch, two steps without and two with `--remat` from the same
   state: losses within 1e-3 relative, BN running statistics within 2^-8
   of each leaf's max, and remat's peak memory below the plain step's;
   then 6 further synced steps of each for its ms/step; (g) the same run's
   `--profile_steps 1 --profile_start 1` leaves one torch.profiler trace in
   its logs_dir; (h) `cli.test.main` on 48 synthetic test frames
   (complex_yolov4 @608 bf16, batch 8, points raster), the launch counts
   set to 0 just before: stem 1 and 3x3 5 per batch, detections finite,
   inference ms per frame and frames/s of the first batch (cold) and of
   the 5 after it (warm).

Each phase prints its wall time on a `[time]` line.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record (launches: the sum over the served, evaluated
and tested runs of phases 4, 5 and 7, the f32 rows' over phase 6's f32
runs), and the line before that nvidia-smi's name and power limit.
"""

from __future__ import annotations

import copy
import functools
import importlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH = 8
REQUESTS = 8
SEED = 0
# (name, H=W in, C_in, C_out, stride) of the 3x3-kernel layers at 608
CONV3X3_LAYERS = (("L1", 608, 32, 64, 2), ("L6", 304, 32, 64, 1),
                  ("L11", 304, 64, 128, 2), ("L16", 152, 64, 64, 1),
                  ("L19", 152, 64, 64, 1))
# decoded-head comparison, kernel path vs plain path (both bf16 on the card):
# per-column max |diff| relative to the column's scale, and abs on conf/cls
DECODED_REL_TOL = 2e-2
PROB_ABS_TOL = 1e-2
# the same in f32 (both paths round the 3x3 layers' x and w to bf16 alike,
# only the f32 summation order differs; an H100 reads about 1e-6): per
# column relative and conf/cls absolute
F32_HEADS_TOL = 1e-3
MODEL = "complex_yolov4"
# kernel launches per request. Path 1: layer 0 -> stem, layers 1, 6, 11,
# 16, 19 -> conv3x3. Path 2: layer 0 -> stem, layers 1, 11 -> conv3x3,
# layers 2-10 and 12-23 -> two fused-stage launches, 68 convs -> int8.
LAUNCHES_PATH1 = {"stem_conv3x3": 1, "conv3x3_fused": 5, "fused_stage": 0, "int8_conv": 0}
LAUNCHES_PATH2 = {"stem_conv3x3": 1, "conv3x3_fused": 2, "fused_stage": 2, "int8_conv": 68}
# fused stage vs plain: both round to bf16 after every op, so a 1-ulp flip
# from another f32 summation order can run through up to 12 ops. The error
# is absolute, on the scale of the intermediates, so it is held to the
# output's max and not to the local value (near-zero outputs cancel). On an
# H100 over seeds 0-5 the main-path segments read 0.0018-0.0090 of max
# |plain|: at most 2 bf16 steps of values in [0.5, 1).
FUSED_REL_TOL = 1e-2
# (model, segment span, H=W, batch): the main-path segments first
FUSED_CASES = (("complex_yolov4", (2, 10), 304, 8), ("complex_yolov4", (12, 23), 152, 8),
               ("complex_yolov4_tiny", (2, 8), 152, 8), ("complex_yolov3", (2, 4), 304, 8),
               ("complex_yolov3", (6, 11), 152, 8), ("complex_yolov4", (12, 23), 76, 2))
KERNEL_NAMES = ("stem_conv3x3", "conv3x3_fused", "fused_stage", "int8_conv")
# the f32 instance of the 3x3 kernel and the int8 conv's f32 output: their
# own rows in the kernels line; their launches are the 3x3 and int8
# wrappers' counts in the f32 runs (phase 6)
F32_ROW = "conv3x3_fused_f32"
INT8_F32_ROW = "int8_conv_f32"
F32_REL_TOL = 1e-4
# phase 6: train / val frames, batch, micro-batches per optimizer step; the
# throughput's timed windows and steps per window, and its profiled steps
TRAIN_FRAMES, TRAIN_VAL_FRAMES, TRAIN_BATCH, TRAIN_SUBDIV = 16, 24, 4, 2
TRAIN_WINDOWS, TRAIN_WINDOW_STEPS, PROFILED_STEPS = 3, 8, 3
# phase 5: (label, extra CLI flags, FUSED_STAGE) of the evaluated configurations
EVAL_FRAMES = 16
EVAL_CONF = 0.45
# phase 7: test frames of cli.test (6 batches: one cold, five warm); train
# frames of the --mosaic run (12 micro-batches, ten timed); (seed, index)
# pairs of the mosaic check; the remat losses' relative tolerance (bf16) and
# the synced steps timed after the two compared ones
TEST_FRAMES = 48
MOSAIC_FRAMES = 48
MOSAIC_PAIRS = ((0, 0), (1, 5), (2, 11))
REMAT_LOSS_REL = 1e-3
REMAT_TIMED_STEPS = 6
EVAL_CONFIGS = (("points", (), False), ("cells", ("--cells_raster",), False),
                ("host", ("--host_raster",), False),
                ("int8", ("--quantize", "int8", "--calib_batches", "1"), True))
SOURCES = {"stem_conv3x3": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           "conv3x3_fused": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           F32_ROW: "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           INT8_F32_ROW: "complex_yolov4_tpu_torch/csrc/int8_conv.cu",
           "fused_stage": "complex_yolov4_tpu_torch/csrc/fused_stage.cu",
           "int8_conv": "complex_yolov4_tpu_torch/csrc/int8_conv.cu"}
REPLACES = {"stem_conv3x3": "complex_yolov4_tpu/ops/stem_conv.py:112",
            "conv3x3_fused": "complex_yolov4_tpu/ops/pallas_conv.py:92",
            F32_ROW: "complex_yolov4_tpu/ops/pallas_conv.py:92",
            INT8_F32_ROW: "complex_yolov4_tpu/models/network.py:456",
            "fused_stage": "complex_yolov4_tpu/ops/fused_stage.py:495",
            "int8_conv": "complex_yolov4_tpu/models/network.py:456"}


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# HBM bytes/s and tensor-core operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def bound_ms(bytes_moved: float, ops: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take for
    the work, the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its operations over the tensor-core
    peak for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_work(b, h, w, c_in, c_out, k, stride, x_bytes, out_bytes, w_bytes):
    """(bytes, operations) of one k x k conv with a bias, from its shapes:
    x (b, h, w, c_in) read once, weight and bias read once, out (b, h/s,
    w/s, c_out) written once; 2 operations per multiply-add."""
    ho, wo = h // stride, w // stride
    moved = (b * h * w * c_in * x_bytes + k * k * c_in * c_out * w_bytes + c_out * 4
             + b * ho * wo * c_out * out_bytes)
    return moved, 2.0 * b * ho * wo * c_out * k * k * c_in


def new_record():
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bytes_bound_ms": 0.0, "library_ms": 0.0}


def add_bound(rec, moved, ops, kind, count=1):
    """Add one shape's bound (times `count` layers) to a kernel's record;
    returns the shape's (ms, bound_by)."""
    ms, by = bound_ms(moved, ops, kind)
    rec["bound_ms"] += ms * count
    if by == "bytes":
        rec["bytes_bound_ms"] += ms * count
    return ms, by


def bf16_ulp_error(got: torch.Tensor, ref: torch.Tensor, floor_frac: float = 2.0 ** -10):
    """(max abs error, max error in bf16 ulps of the reference). Values
    below floor_frac * max|ref| are measured in the ulp of that floor."""
    g, r = got.float(), ref.float()
    floor = r.abs().max().clamp(min=1e-30) * floor_frac
    mag = torch.maximum(r.abs(), floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7.0)
    err = (g - r).abs()
    return float(err.max()), float((err / ulp).max())


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 10, reps: int = 3) -> float:
    """Device ms per call: `calls` calls captured once in a CUDA graph and
    replayed `reps` times, CUDA events around the replays, so the host's
    cost of launching each call is left out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def timed_pair(kernel_fn, plain_fn, reps: int):
    """Kernel and plain ms, measured in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def library_conv_ms(x_nhwc, w_packed, bias, stride, reps: int, dtype=None) -> float:
    """ms of one cuDNN `F.conv2d` computing the same conv (bias, no
    activation) on the channels_last view of the kernel's input: the
    yardstick of `library_ms`, which the port never calls. The conv runs in
    `dtype` (default bf16: an f32 input, the stem's raster, is cast to bf16
    first, outside the timing; f32 for the f32 instance, TF32 off as set in
    phase 1). cuDNN's autotuner is on for this timing only."""
    import torch.nn.functional as F

    c_in, c_out = x_nhwc.shape[-1], w_packed.shape[1]
    dtype = dtype or torch.bfloat16
    x = x_nhwc.to(dtype).permute(0, 3, 1, 2)
    # channels_last like x, so that no call converts it inside the timing
    w = (w_packed.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1).to(dtype)
         .contiguous(memory_format=torch.channels_last))
    b = bias.to(dtype)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return time_ms(lambda: F.conv2d(x, w, b, stride=stride, padding=1), reps)
    finally:
        torch.backends.cudnn.benchmark = saved


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        sys.exit(1)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count, smi.splitlines()[0]


def phase_build():
    from complex_yolov4_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build()
    _build.load()
    print(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_kernels(dev):
    from complex_yolov4_tpu_torch.ops import conv3x3 as conv_mod
    from complex_yolov4_tpu_torch.ops import stem_conv as stem_mod

    rng = np.random.default_rng(SEED)
    # the activations are drawn on the card (seeded): up to 95M values a
    # shape, seconds of host time in numpy
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operands(hw, c_in, c_out, x_dtype):
        shape = (BATCH, hw, hw, c_in)
        x = (torch.rand(shape, generator=gen, device=dev) if x_dtype == torch.float32
             else torch.randn(shape, generator=gen, device=dev))
        bound = float(np.sqrt(1.0 / (9 * c_in)))
        w = rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32)
        b = rng.normal(0.0, 0.1, c_out).astype(np.float32)
        return (x.to(x_dtype), conv_mod.pack_weight(torch.from_numpy(w)).to(dev),
                torch.from_numpy(b).to(dev))

    # (label, key, x, w, b, stride, kernel fn, plain fn, timing reps)
    cases = []
    x, w, b = operands(608, 3, 32, torch.float32)
    cases.append(("stem L0", "stem_conv3x3", x, w, b, 1,
                  lambda x, w, b, s: stem_mod.conv3x3_stem(x, w, b, activation="mish"),
                  lambda x, w, b, s: stem_mod.stem_plain(x, w, b, activation="mish"), 10))
    for name, hw, c_in, c_out, stride in CONV3X3_LAYERS:
        x, w, b = operands(hw, c_in, c_out, torch.bfloat16)
        cases.append((f"conv3x3 {name}", "conv3x3_fused", x, w, b, stride,
                      lambda x, w, b, s: conv_mod.conv3x3_fused(x, w, b, stride=s,
                                                                activation="mish"),
                      lambda x, w, b, s: conv_mod.conv3x3_plain(x, w, b, stride=s,
                                                                activation="mish"), 10))
    # the f32 instance: an f32 x (an f32 network's activation), f32 out
    for name, hw, c_in, c_out, stride in CONV3X3_LAYERS:
        x, w, b = operands(hw, c_in, c_out, torch.float32)
        x = x * 4.0 - 2.0  # signed, as an activation
        cases.append((f"conv3x3 f32 {name}", F32_ROW, x, w, b, stride,
                      lambda x, w, b, s: conv_mod.conv3x3_fused(x, w, b, stride=s,
                                                                activation="mish"),
                      lambda x, w, b, s: conv_mod.conv3x3_plain(x, w, b, stride=s,
                                                                activation="mish"), 10))
    del x, w, b

    records = {"stem_conv3x3": new_record(), "conv3x3_fused": new_record(),
               F32_ROW: new_record()}
    failed = []
    for name, key, x, w, b, stride, kernel, plain, reps in cases:
        k_out = kernel(x, w, b, stride)
        torch.cuda.synchronize()
        p_out = plain(x, w, b, stride)
        torch.cuda.synchronize()
        f32 = key == F32_ROW
        if f32:  # same bf16 rounding of x and w on both sides: only the sum order differs
            abs_err = float((k_out - p_out).abs().max())
            rel = abs_err / float(p_out.abs().max())
            ok = (k_out.shape == p_out.shape and k_out.dtype == torch.float32
                  and bool(torch.isfinite(k_out).all()) and rel <= F32_REL_TOL)
            err_text = f"max_abs_err={abs_err:.6g} rel_err={rel:.3g} (tol {F32_REL_TOL})"
        else:
            abs_err, ulps = bf16_ulp_error(k_out, p_out)
            ok = (k_out.shape == p_out.shape and k_out.dtype == torch.bfloat16
                  and bool(torch.isfinite(k_out.float()).all()) and ulps <= 1.0)
            err_text = f"max_abs_err={abs_err:.6g} max_err_ulps={ulps:.3f}"
        del k_out, p_out
        k_ms, p_ms = timed_pair(lambda: kernel(x, w, b, stride), lambda: plain(x, w, b, stride),
                                reps)
        lib_ms = library_conv_ms(x, w, b, stride, reps, torch.float32 if f32 else None)
        bsz, h, wd, c_in = x.shape
        c_out = w.shape[1]
        out_bytes = 4 if f32 else 2
        moved, ops = conv_work(bsz, h, wd, c_in, c_out, 3, stride, x.element_size(),
                               out_bytes, 2)
        bnd, by = add_bound(records[key], moved, ops, "bf16")
        print(f"[kernels] {name} x{tuple(x.shape)} -> {c_out} s{stride}: "
              f"{err_text} kernel_ms={k_ms:.4f} "
              f"bound_ms={bnd:.4f} ({by}: {moved / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
              f"library_ms={lib_ms:.4f} plain_ms={p_ms:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        r = records[key]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        r["library_ms"] += lib_ms
    print("[kernels] library_ms: one cuDNN F.conv2d (bf16, channels_last, bias, "
          "cudnn.benchmark on; f32 with TF32 off for the f32 instance) for the same conv; "
          "it leaves out the activation, which favours the library. A yardstick only: the "
          "port never calls it. The f32 instance's bound counts its products at the bf16 "
          "tensor-core peak (it rounds x and w to bf16) and its f32 input and output bytes.")
    if failed:
        raise AssertionError(f"kernel vs plain disagree beyond their bound: {failed}")
    return records


def fused_executed_flop(lay, batch: int, hw: int) -> float:
    """FLOP the fused-stage kernel executes on a (batch, hw, hw) input: per
    block, each conv over its region (the output tile grown by the 3x3 convs
    still after it), from the op table (`csrc/fused_stage.cu`)."""
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    ty, tx = lay.win_h - 2 * lay.halo, lay.win_w - 2 * lay.halo
    ints = lay.ints
    per_block = 0
    for r in range(ints[0]):
        row = ints[fs.HEADER_INTS + r * fs.ROW_INTS:][:fs.ROW_INTS]
        if row[0] != fs.KIND_CODES["shortcut"]:
            per_block += 2 * row[9] * row[2] * (ty + 2 * row[7]) * (tx + 2 * row[7])
    return float(per_block * batch * -(-hw // ty) * -(-hw // tx))


def phase_fused(dev):
    """Fused-stage kernel vs its plain version; ms per request (batch 8) is
    the sum over the two main-path segments."""
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    rec = new_record()
    rec["library_ms"] = None
    failed = []
    nets = {}  # model name -> (spec, weights on the card), made once
    for n, (name, span, hw, batch) in enumerate(FUSED_CASES):
        if name not in nets:
            spec = zoo.get_model_spec(name)
            params, state = weights.init_params_np(spec, SEED)
            nets[name] = (spec, {k: v.to(dev) for k, v in
                                 weights.from_jax_params(spec, params, state).items()})
        spec, st = nets[name]
        seg = next(s for s in fs.plan_segments(spec, 608) if (s.start, s.end) == span)
        sw = fs.segment_weights(seg, st)
        x = torch.from_numpy(np.random.default_rng(SEED + n).normal(
            0.0, 1.0, (batch, hw, hw, seg.cin)).astype(np.float32)).to(dev, torch.bfloat16)
        got = fs.apply_segment(seg, x, sw)
        torch.cuda.synchronize()
        ref = fs.fused_stage_plain(seg, x, sw)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        ok = (got.shape == ref.shape and bool(torch.isfinite(got.float()).all())
              and err <= FUSED_REL_TOL * scale)
        timing = ""
        if n < 2:  # the main-path segments at batch 8
            k_ms, p_ms = timed_pair(lambda: fs.apply_segment(seg, x, sw),
                                    lambda: fs.fused_stage_plain(seg, x, sw), 5)
            rec["ms"] += k_ms
            rec["plain_ms"] += p_ms
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # useful work only: each conv at the segment's output size (no
            # halo recompute); the input, output and weights cross HBM once
            ops = sum(2.0 * batch * hw * hw * o.cin * o.cout * (9 if o.kind == "conv3x3" else 1)
                      for o in seg.ops if o.kind.startswith("conv"))
            moved = (x.numel() * 2 + got.numel() * 2 + sw.w_flat.numel() * 2
                     + sw.b_flat.numel() * 4)
            bnd, by = add_bound(rec, moved, ops, "bf16")
            done = fused_executed_flop(sw.layout, batch, hw)
            timing = (f" kernel_ms={k_ms:.4f} bound_ms={bnd:.4f} ({by}: {moved / 1e6:.1f} MB, "
                      f"{ops / 1e9:.2f} GFLOP) executed {done / 1e9:.2f} GFLOP at "
                      f"{done / k_ms / 1e9:.1f} TFLOP/s (useful {ops / k_ms / 1e9:.1f}) "
                      f"plain_ms={p_ms:.4f}")
        lay = sw.layout
        print(f"[kernels] fused_stage {name} {span[0]}-{span[1]} x{tuple(x.shape)} -> "
              f"{seg.cout}: window {lay.win_h}x{lay.win_w} halo {lay.halo} "
              f"smem {lay.smem_bytes} B; max_abs_err={err:.6g} "
              f"(tol {FUSED_REL_TOL} * {scale:.4g}){timing} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {span}")
        del x, got, ref
    print("[kernels] fused_stage library_ms: null, no single PyTorch call computes a CSP "
          "stage; its reference is path 1's executor on the same layers (phase 4, "
          "layerwise_segments)")
    if failed:
        raise AssertionError(f"fused stage vs plain beyond tolerance: {failed}")
    return rec


def _int8_layers():
    """(key, output chained) per quantized conv of complex_yolov4 at 608
    (`default_skip`): key = (k, stride, C_in, C_out, H_in, input dtype),
    the input "int8" where the producer is a chained conv
    (`quantize.chain_set`), else "bf16", which the kernel quantizes as it
    loads it; the output is chained (int8) where the conv itself is."""
    from complex_yolov4_tpu_torch.models import quantize as qz
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.spec import ConvSpec

    spec = zoo.get_model_spec(MODEL)
    chans = (spec.in_channels,) + spec.out_channels()
    strides = spec.out_strides()
    skip = qz.default_skip(spec)
    quant = [i for i, layer in enumerate(spec.layers)
             if isinstance(layer, ConvSpec) and i not in skip]
    chain = qz.chain_set(spec, [f"layer{i}" for i in quant])
    for i in quant:
        layer = spec.layers[i]
        yield ((layer.size, layer.stride, chans[i], layer.filters, 608 // strides[i - 1],
                "int8" if i - 1 in chain else "bf16"), i in chain)


def int8_shapes():
    """{(k, stride, C_in, C_out, H_in, input dtype): count} over complex_yolov4's
    quantized convs at 608 (`_int8_layers`)."""
    shapes = {}
    for key, _ in _int8_layers():
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def int8_chained_out():
    """{shape key of `int8_shapes`: how many of its convs write int8 for a
    chained consumer}; the others write the compute dtype."""
    chained = {}
    for key, out_int8 in _int8_layers():
        chained[key] = chained.get(key, 0) + int(out_int8)
    return chained


def library_int_mm_ms(x, w, reps: int) -> float:
    """ms of one `torch._int_mm` (int8 x int8 -> int32, cuBLAS) computing a
    1x1 stride-1 conv's sums: x (B, H, W, C_in) viewed as (B*H*W, C_in)
    times w (C_out, C_in) transposed. It leaves out the input quantization,
    the dequantization, bias and activation. The yardstick of the int8
    row's `library_ms`, which the port never calls."""
    a, b = x.reshape(-1, x.shape[-1]), w.t()
    return time_ms(lambda: torch._int_mm(a, b), reps)


def phase_int8(dev):
    """int8 kernel vs its plain version at every distinct quantized shape,
    batch 8, with the input route path 2 gives it (int8 from a chained
    producer, else bf16 quantized in the kernel), in the int32, bf16 and
    int8 output modes; ms per request is the bf16-mode time summed over the
    68 layers. library_ms covers the 1x1 layers only (`library_int_mm_ms`):
    no PyTorch call computes an int8 3x3 conv on CUDA. Also the f32 output
    mode (f32 compute), checked on the same inputs; its own record,
    returned second, times the int8 conv as f32 compute runs it: every
    input int8 (the network quantizes an f32 activation before the call),
    the chained convs writing int8 for their consumer, the others f32."""
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    shapes, chained = int8_shapes(), int8_chained_out()
    assert sum(shapes.values()) == 68, shapes
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)  # activations, drawn on the card
    rec = new_record()
    rec.update(library_ms=None, library_layers=0, ms_on_library_layers=0.0, device_ms=0.0,
               library_device_ms=0.0, device_ms_on_library_layers=0.0)
    rec_f32 = new_record()
    rec_f32.update(library_ms=None, device_ms=0.0)
    failed = []
    s_x = np.float32(3.0 / 127.0)
    inv_s_x = float(np.float32(1.0) / s_x)
    for key, count in sorted(shapes.items()):
        k, stride, c_in, c_out, hw, src = key
        shape = (BATCH, hw, hw, c_in)
        x8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        # a bf16 input: N(0, 1), a few values past the clip at +-3
        x = x8 if src == "int8" else torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.from_numpy(rng.integers(-127, 128, (c_out, k * k * c_in)).astype(np.int8)).to(dev)
        # scales of a real layer: |h| of order 1 for |y| ~ sqrt(K) * 127^2 / 3
        s_w = rng.uniform(0.5, 1.5, c_out) / (127.0 * np.sqrt(k * k * c_in))
        scale = torch.from_numpy(s_w.astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0.0, 0.1, c_out).astype(np.float32)).to(dev)
        kw = {"ksize": k, "stride": stride, "s_x": float(s_x), "activation": "mish",
              "inv_s_x": inv_s_x}
        inv_next = float(np.float32(1.0) / np.float32(3.0 / 127.0))
        g32 = i8.int8_conv(x, w, scale, b, out="int32", **kw)
        gbf = i8.int8_conv(x, w, scale, b, **kw)
        gi8 = i8.int8_conv(x, w, scale, b, out="int8", inv_s_next=inv_next, **kw)
        gf32 = i8.int8_conv(x, w, scale, b, out="f32", **kw)
        torch.cuda.synchronize()
        p32 = i8.int8_conv_plain(x, w, scale, b, out="int32", **kw)
        pbf = i8.epilogue(p32, scale, b, s_x=kw["s_x"], activation="mish", out="bf16")
        pi8 = i8.epilogue(p32, scale, b, s_x=kw["s_x"], activation="mish", out="int8",
                          inv_s_next=inv_next)
        pf32 = i8.epilogue(p32, scale, b, s_x=kw["s_x"], activation="mish", out="f32")
        torch.cuda.synchronize()
        eq32 = torch.equal(g32, p32)
        abs_err, ulps = bf16_ulp_error(gbf, pbf)
        d8 = int((gi8.int() - pi8.int()).abs().max())
        f32_rel = float((gf32 - pf32).abs().max() / pf32.abs().max())
        rec_f32["max_abs_err"] = max(rec_f32["max_abs_err"], float((gf32 - pf32).abs().max()))
        k_ms, p_ms = timed_pair(lambda: i8.int8_conv(x, w, scale, b, **kw),
                                lambda: i8.int8_conv_plain(x, w, scale, b, **kw), 5)
        dev_ms = device_ms(lambda: i8.int8_conv(x, w, scale, b, **kw))
        rec["device_ms"] += dev_ms * count
        # f32 compute: int8 x; out="int8" on the chained convs, "f32" on the rest
        f_text = []
        for n, out_kw in ((count - chained[key], {"out": "f32"}),
                          (chained[key], {"out": "int8", "inv_s_next": inv_next})):
            if n == 0:
                continue
            f_ms, fp_ms = timed_pair(lambda: i8.int8_conv(x8, w, scale, b, **out_kw, **kw),
                                     lambda: i8.int8_conv_plain(x8, w, scale, b, **out_kw, **kw),
                                     5)
            f_dev = device_ms(lambda: i8.int8_conv(x8, w, scale, b, **out_kw, **kw))
            moved_f, ops_f = conv_work(BATCH, hw, hw, c_in, c_out, k, stride, 1,
                                       4 if out_kw["out"] == "f32" else 1, 1)
            add_bound(rec_f32, moved_f + 4 * c_out, ops_f, "int8", n)
            rec_f32["ms"] += f_ms * n
            rec_f32["plain_ms"] += fp_ms * n
            rec_f32["device_ms"] += f_dev * n
            f_text.append(f"{out_kw['out']} out x{n} {f_ms:.4f}, device {f_dev:.4f}")
        ok = (eq32 and ulps <= 1.0 and d8 <= 1 and bool(torch.isfinite(gbf.float()).all())
              and gf32.dtype == torch.float32 and f32_rel <= 1e-5)
        # bf16-output mode, as timed: int8 or bf16 x, int8 w, f32 scale, bf16 out
        moved, ops = conv_work(BATCH, hw, hw, c_in, c_out, k, stride, x.element_size(), 2, 1)
        bnd, by = add_bound(rec, moved + 4 * c_out, ops, "int8", count)
        lib = "null (3x3)" if k == 3 else "null (stride 2)"
        if k == 1 and stride == 1:
            lib_ms = library_int_mm_ms(x8, w, 5)
            a2, w2 = x8.reshape(-1, c_in), w.t()
            lib_dev = device_ms(lambda: torch._int_mm(a2, w2))
            lib = f"{lib_ms:.4f} (device {lib_dev:.4f})"
            rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms * count
            rec["library_layers"] += count
            rec["ms_on_library_layers"] += k_ms * count
            rec["library_device_ms"] += lib_dev * count
            rec["device_ms_on_library_layers"] += dev_ms * count
        print(f"[kernels] int8_conv k{k} s{stride} {c_in}->{c_out} @{hw} {src} in x{count}: "
              f"int32_equal={eq32} bf16 max_abs_err={abs_err:.6g} max_err_ulps={ulps:.3f} "
              f"int8 max_diff={d8} f32 rel_err={f32_rel:.3g} (tol 1e-5) "
              f"kernel_ms={k_ms:.4f} (device {dev_ms:.4f}; f32 compute from int8 x: "
              f"{'; '.join(f_text)}) library_ms={lib} "
              f"bound_ms={bnd:.4f} ({by}) TOP/s={ops / dev_ms / 1e9:.1f} plain_ms={p_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((k, stride, c_in, c_out, hw, src))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        rec["ms"] += k_ms * count
        rec["plain_ms"] += p_ms * count
        del x, x8, w, g32, gbf, gi8, gf32, p32, pbf, pi8, pf32
    print(f"[kernels] int8_conv library_ms: one torch._int_mm (cuBLAS int8 -> int32) per "
          f"1x1 conv, summed over those {rec['library_layers']} of the 68 layers: "
          f"{rec['library_ms']:.4f} ms against the kernel's {rec['ms_on_library_layers']:.4f} "
          f"ms on the same layers (device time, CUDA graph replay, no launch cost: "
          f"{rec['library_device_ms']:.4f} against {rec['device_ms_on_library_layers']:.4f}). "
          f"It leaves out the input quantization, the dequantization, "
          f"bias and activation, which favours the library. No PyTorch call computes an int8 "
          f"3x3 conv on CUDA, so the 3x3 layers have none. A yardstick only: the port never "
          f"calls it.")
    print(f"[kernels] int8_conv 68 layers: {rec['ms']:.4f} ms per request (target 2.0); "
          f"device time {rec['device_ms']:.4f} ms")
    # the library call computes the same int32 sums whatever the output mode
    rec_f32["library_ms"] = rec["library_ms"]
    print(f"[kernels] int8_conv in f32 compute, 68 layers from int8 inputs "
          f"({sum(chained.values())} chained convs writing int8, the others f32): "
          f"{rec_f32['ms']:.4f} ms per request, device time {rec_f32['device_ms']:.4f} ms, "
          f"bound {rec_f32['bound_ms']:.4f} ms (f32 outputs written by the threads, no TMA "
          f"store)")
    if failed:
        raise AssertionError(f"int8 kernel vs plain disagree: {failed}")
    return rec, rec_f32


@functools.lru_cache(maxsize=None)
def raw_scenes(r: int):
    """The 8 raw (uncropped) synthetic point clouds of request r (made once,
    beside nvcc: `host_side`)."""
    from complex_yolov4_tpu_torch.data import synthetic

    return [synthetic.sample_scene(np.random.default_rng(1000 * (r + 1) + b))[0]
            for b in range(BATCH)]


def make_scenes(r: int):
    """Set-up, untimed: the 8 cropped synthetic point clouds of request r."""
    from complex_yolov4_tpu_torch.data import bev

    return [bev.remove_points_outside(c) for c in raw_scenes(r)]


def host_coo(clouds, aggregate=None):
    """Host side of one request: clouds -> flat COO arrays, with the serving
    capacity policy (live cells + 1/8 headroom). `aggregate` maps a cloud
    to its (cells, keys): by default numpy's `aggregate_bev_cells` of a
    cropped cloud (phase 4 serves with it)."""
    from complex_yolov4_tpu_torch.data import bev

    cells_l, keys_l = zip(*map(aggregate or bev.aggregate_bev_cells, clouds))
    total = sum(len(c) for c in cells_l)
    return bev.pack_cells_flat(list(cells_l), list(keys_l), total + total // 8)


def raster(req, dev, frames):
    from complex_yolov4_tpu_torch.data import bev

    cells, keys, dens = (torch.as_tensor(a, device=dev) for a in req)
    return bev.make_bev_map_from_cells(cells, keys, dens, frames)


def counters():
    from complex_yolov4_tpu_torch.ops import conv3x3, fused_stage, int8_conv, stem_conv

    return {"stem_conv3x3": stem_conv.conv3x3_stem, "conv3x3_fused": conv3x3.conv3x3_fused,
            "fused_stage": fused_stage.apply_segment, "int8_conv": int8_conv.int8_conv}


def build_models(dev):
    """(spec, path-1 model, path-2 model): complex_yolov4 @608 bf16 from
    seed-0 weights; path 2 quantized by `default_skip` after calibration on
    2 synthetic frames (as bench.py does), with both fused CSP stages."""
    from complex_yolov4_tpu_torch.data import bev, synthetic
    from complex_yolov4_tpu_torch.models import quantize as qz
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.models.network import Darknet

    spec = zoo.get_model_spec(MODEL)
    params, state = weights.init_params_np(spec, SEED)
    folded = weights.fold_batchnorm(spec, params, state)
    st = weights.from_folded(spec, folded)
    path1 = Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev)
    clouds = [bev.remove_points_outside(synthetic.sample_scene(
        np.random.default_rng(100 + i))[0]) for i in range(2)]
    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
    req = bev.pack_cells_flat(list(cells_l), list(keys_l), sum(len(c) for c in cells_l))
    calib = raster(req, dev, 2).cpu().numpy()
    t0 = time.perf_counter()
    tree = qz.quantize_model(spec, folded, [calib], device=dev)
    print(f"[slice] int8 PTQ: {len(tree)} convs calibrated on 2 frames in "
          f"{time.perf_counter() - t0:.1f} s")
    path2 = Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev,
                    quant=weights.from_jax_quant(spec, tree), fused_stages=True)
    return spec, path1, path2


def serve_path(label, spec, model, expected, compare_batch, dev):
    """Serve REQUESTS requests of BATCH raw clouds through make_inference_fn,
    each twice: its COO built by numpy (crop, `aggregate_bev_cells`, pack)
    and by the native library (`aggregate_cells` crops inside), in
    alternating order, the packed arrays held equal. The launch counts are
    set to 0 just before and read just after. Prints each COO's measured
    e2e (host COO + device part, served one after the other). Returns the
    launches."""
    from complex_yolov4_tpu_torch import native
    from complex_yolov4_tpu_torch.data import bev
    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn

    routes = model.routes(608)
    kinds = {}
    for r in routes.values():
        kinds[r] = kinds.get(r, 0) + 1
    print(f"[slice] {label}: {MODEL} @608 bf16, {len(spec.layers)} layers, "
          f"routed layers by kernel {kinds}")
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64, from_cells=True)
    coo = {"numpy": lambda raw: host_coo([bev.remove_points_outside(c) for c in raw]),
           "native": lambda raw: host_coo(raw, native.aggregate_cells)}
    infer(model, *coo["numpy"](raw_scenes(-1)), BATCH)  # warm-up
    infer(model, *coo["native"](raw_scenes(-1)), BATCH)
    torch.cuda.synchronize()

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    host_s = {k: [] for k in coo}
    infer_s = {k: [] for k in coo}
    outs = []
    for r in range(REQUESTS):
        reqs = {}
        for kind in (("numpy", "native") if r % 2 == 0 else ("native", "numpy")):
            t0 = time.perf_counter()
            req = reqs[kind] = coo[kind](raw_scenes(r))
            t1 = time.perf_counter()
            dets, masks = infer(model, *req, BATCH)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host_s[kind].append(t1 - t0)
            infer_s[kind].append(t2 - t1)
            outs.append((r, kind, req, dets, masks))
        if not all(np.array_equal(a, b) for a, b in zip(reqs["numpy"], reqs["native"])):
            raise AssertionError(f"request {r}: native COO pack differs from numpy")
    launches = {k: fn.launches for k, fn in fns.items()}
    print(f"[slice] {label} launches over {REQUESTS} requests served twice: {launches}")
    want = {k: n * 2 * REQUESTS for k, n in expected.items()}
    if launches != want:
        raise AssertionError(f"{label} did not run through the kernels: {launches} != {want}")

    for r, kind, req, dets, masks in outs:
        if tuple(dets.shape) != (BATCH, 64, 9) or tuple(masks.shape) != (BATCH, 64):
            raise AssertionError(f"request {r}: shapes {tuple(dets.shape)} {tuple(masks.shape)}")
        if not bool(torch.isfinite(dets).all()):
            raise AssertionError(f"request {r}: non-finite detections")
        if kind == "numpy":
            print(f"[slice] {label} request {r}: cells={int((req[0] < BATCH * 609 * 609).sum())} "
                  f"detections/frame={masks.sum(1).int().tolist()}")
    for kind in coo:
        h, d = np.array(host_s[kind]), np.array(infer_s[kind])
        e2e = h + d
        print(f"[slice] {label} served with {kind} COO, {REQUESTS} requests: host COO ms "
              + " ".join(f"{x * 1e3:.2f}" for x in h) + f" (mean {h.mean() * 1e3:.2f}); "
              f"device part (raster..NMS) mean={d.mean() * 1e3:.2f} ms "
              f"frames/s={BATCH / d.mean():.2f}; e2e (host COO + device, measured) "
              f"mean={e2e.mean() * 1e3:.2f} ms frames/s={BATCH / e2e.mean():.2f}")
    first = next(o for o in outs if o[1] == "numpy")

    # decoded heads: kernel path vs all-plain path on the card
    with torch.inference_mode():
        img = raster(first[2], dev, BATCH)[:compare_batch].permute(0, 3, 1, 2)
        got = model(img, kernels=True)
        ref = model(img, kernels=False)
    torch.cuda.synchronize()
    n_boxes = spec.num_boxes(608)
    if tuple(got.shape) != (compare_batch, n_boxes, 10) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"decoded heads: shape {tuple(got.shape)} or non-finite")
    diff = (got - ref).abs().amax(dim=(0, 1))
    scale = ref.abs().amax(dim=(0, 1)) + 1e-6
    rel = float((diff / scale).max())
    prob = float(diff[6:].max())
    print(f"[slice] {label} decoded ({compare_batch}, {n_boxes}, 10) kernel vs plain path: "
          f"max rel err per column={rel:.3g} (tol {DECODED_REL_TOL}), "
          f"max abs err conf/cls={prob:.3g} (tol {PROB_ABS_TOL})")
    if rel > DECODED_REL_TOL or prob > PROB_ABS_TOL:
        raise AssertionError(f"{label}: kernel path and plain path disagree")
    return launches


def layerwise_segments(model, dev):
    """What path 1's executor spends on the layers the fused stages take:
    prefix forwards stopped after layers 1, 10, 11 and 23, batch 8, CUDA
    events; layers 2-10 = prefix(10) - prefix(1), 12-23 = prefix(23) -
    prefix(11)."""
    img = raster(host_coo(make_scenes(0)), dev, BATCH).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ms = {k: time_ms(lambda k=k: model(img, stop_after=k), 5) for k in (1, 10, 11, 23)}
    a, b = ms[10] - ms[1], ms[23] - ms[11]
    print(f"[slice] path 1 executor (cuDNN 1x1 + eager epilogues + 3x3 kernel) on the fused "
          f"layers, batch 8: layers 2-10 {a:.4f} ms, layers 12-23 {b:.4f} ms, "
          f"sum {a + b:.4f} ms (prefix differences)")


def phase_split(label, model, dev):
    """One request of 8: host COO, raster, network, NMS with a sync around
    each (5 reps), then torch.profiler over 2 requests: device busy time
    and the 25 device-side rows with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
    from complex_yolov4_tpu_torch.ops.nms import nms_batch

    clouds = make_scenes(0)
    parts = {"host_coo": [], "h2d_raster": [], "network": [], "nms": []}
    with torch.inference_mode():
        for _ in range(6):
            t0 = time.perf_counter()
            req = host_coo(clouds)
            t1 = time.perf_counter()
            img = raster(req, dev, BATCH)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dec = model(img.permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            nms_batch(dec, 0.5, 0.5, 64)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(v * 1e3)
    print(f"[split] {label} ms/request (5 reps after 1 warm-up): " + ", ".join(
        f"{k} {np.mean(v[1:]):.2f} (min {np.min(v[1:]):.2f})" for k, v in parts.items()))
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64, from_cells=True)
    req = host_coo(clouds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            infer(model, *req, BATCH)
        torch.cuda.synchronize()
    # device-side rows only (kernels, memcpy, memset): the rows of the host
    # ops that launched them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[split] {label} device busy over 2 requests: {total:.2f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"[split] {label}  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


def expected_launches(model, batches: int, calib_batches: int):
    """Kernel launches of an evaluation run, from the routes: per batch, one
    per routed stem, 3x3 and int8 layer and one per fused segment, and per
    int8 calibration batch those of the network (no int8, no fused
    segments) that calibrates in the model's compute dtype: in bf16 the
    stem and the 3x3 kernel, in f32 the 3x3 kernel."""
    from complex_yolov4_tpu_torch.models.network import kernel_routes

    def count(routes):
        n = dict.fromkeys(KERNEL_NAMES, 0)
        for r in routes.values():
            if r in ("stem", "conv3x3", "int8"):
                n[{"stem": "stem_conv3x3", "conv3x3": "conv3x3_fused",
                   "int8": "int8_conv"}[r]] += 1
        n["fused_stage"] = len({r for r in routes.values() if r.startswith("fused_stage")})
        return n

    per_batch = count(model.routes(608))
    calib = count(kernel_routes(model.spec, 608, model.compute_dtype))
    total = {k: per_batch[k] * batches + calib[k] * calib_batches for k in KERNEL_NAMES}
    return per_batch, total


def deferred_images(batch, dev):
    from complex_yolov4_tpu_torch.data import bev

    return bev.images_from_deferred_batch(
        {k: torch.as_tensor(batch[k], device=dev) for k in
         ("points", "point_mask", "flip", "holes", "hole_mask")}, 608)


def batch_images(batch, dev):
    """A loader batch of any layout -> its (B, 608, 608, 3) rasters on the card."""
    from complex_yolov4_tpu_torch.data import bev

    if "image" in batch:
        return torch.as_tensor(batch["image"], device=dev)
    if "cells" in batch:
        cells, keys, dens = (torch.as_tensor(batch[k], device=dev)
                             for k in ("cells", "cell_keys", "cell_dens"))
        return bev.make_bev_map_from_cells(cells, keys, dens, batch["batch_cap"])[:batch["batch"]]
    return deferred_images(batch, dev)


def check_points_raster(root, dev):
    """The card's points raster of one batch against the host raster of the
    same frames: the JAX package's packed-mode budget (tests/test_data.py:
    97-110)."""
    from complex_yolov4_tpu_torch.data import loader as ld

    loader = ld.create_val_loader(root, BATCH, device_raster=True)
    batch = next(iter(loader))
    got = deferred_images(batch, dev).cpu().numpy()
    host = np.stack([loader.dataset.load_sample(i)[1] for i in range(BATCH)])
    mismatched = np.abs(got - host).max(axis=-1) > 2.5e-3
    err = np.abs(got[~mismatched] - host[~mismatched]).reshape(-1, 3)
    ok = (mismatched.mean() < 1e-4 and err[:, 0].max() <= 1.0 / 510 + 1e-6
          and err[:, 1].max() <= 3.1e-5 and err[:, 2].max() == 0.0)
    print(f"[eval] points raster on the card vs host make_bev_map, {BATCH} frames: "
          f"{int(mismatched.sum())} of {mismatched.size} cells differ (budget < 1e-4), "
          f"max err intensity {err[:, 0].max():.3g} (<= 1/510), height {err[:, 1].max():.3g} "
          f"(<= 3.1e-5), density {err[:, 2].max():.3g} (== 0) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("points raster on the card outside the packed-mode budget")


def check_oracle(root, dev):
    """The val targets fed as detections (conf 1) through `sample_statistics`
    on the card: AP 1.0 for every class present."""
    from complex_yolov4_tpu_torch.data import loader as ld
    from complex_yolov4_tpu_torch.evaluation import metrics as M

    stats, labels = [], []
    for batch in ld.create_val_loader(root, BATCH):
        for t, m in zip(batch["targets"], batch["target_mask"]):
            live = t[m > 0.5]
            dets = np.zeros((len(t), 9), np.float32)
            dets[:len(live), :4] = live[:, 1:5] * 608
            dets[:len(live), 4:6] = live[:, 5:7]
            dets[:len(live), 6:8] = 1.0
            dets[:len(live), 8] = live[:, 0]
            dmask = (np.arange(len(t)) < len(live)).astype(np.float32)
            stats.append(M.sample_statistics(torch.from_numpy(dets).to(dev),
                                             torch.from_numpy(dmask).to(dev), t, m, 0.5, 608.0))
            labels.append(live[:, 0])
    out = M.summarize_map(stats, labels)
    ok = bool(np.all(out["AP"] == 1.0)) and len(out["ap_class"]) > 0
    print(f"[eval] oracle (val targets as detections, IoU on the card): classes "
          f"{out['ap_class'].tolist()} AP {out['AP'].tolist()} mAP {float(out['mAP']):.4f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("oracle detections do not give AP 1.0")


def check_heads(label, model, batch, dev, frames: int = 2, rel_tol: float = DECODED_REL_TOL,
                prob_tol: float = PROB_ABS_TOL):
    """Decoded heads of the kernel path vs the all-plain path, on the first
    `frames` frames of one batch."""
    with torch.inference_mode():
        img = batch_images(batch, dev)[:frames].permute(0, 3, 1, 2)
        got = model(img, kernels=True)
        ref = model(img, kernels=False)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite decoded heads")
    diff = (got - ref).abs().amax(dim=(0, 1))
    rel = float((diff / (ref.abs().amax(dim=(0, 1)) + 1e-6)).max())
    prob = float(diff[6:].max())
    print(f"[eval] {label} decoded {tuple(got.shape)} kernel vs plain path: max rel err per "
          f"column={rel:.3g} (tol {rel_tol}), max abs err conf/cls={prob:.3g} "
          f"(tol {prob_tol})")
    if rel > rel_tol or prob > prob_tol:
        raise AssertionError(f"{label}: kernel path and plain path disagree")


def eval_loader(root, flags):
    """A val loader of the layout `flags` select; a cells loader has its
    per-frame capacity estimate made already (returned in ms, else None)."""
    from complex_yolov4_tpu_torch.data import loader as ld

    loader = ld.create_val_loader(root, BATCH, device_raster="--host_raster" not in flags,
                                  cells_raster="--cells_raster" in flags)
    cap_ms = None
    if loader.cells_raster:
        t0 = time.perf_counter()
        loader._cells_per_frame_cap()
        cap_ms = (time.perf_counter() - t0) * 1e3
    return loader, cap_ms


def loader_ms(root, flags):
    """Host ms per batch of the loader alone (no prefetch thread, the frame
    pool on) over the 16 frames, the capacity estimate made before the
    clock; and the estimate's ms (cells only, else None)."""
    loader, cap_ms = eval_loader(root, flags)
    loader.prefetch = 0
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) / n * 1e3, cap_ms


def warm_pass(model, root, argv, flags):
    """A second `evaluate_map` pass over the frames on the model of the CLI's
    run, with the CLI's thresholds: every first-use cost is paid already."""
    from complex_yolov4_tpu_torch.config.runtime import parse_eval_config
    from complex_yolov4_tpu_torch.evaluation.evaluator import evaluate_map, make_inference_fn

    config = parse_eval_config(argv)
    loader, _ = eval_loader(root, flags)
    infer = make_inference_fn(conf_thresh=config.conf_thresh, nms_thresh=config.nms_thresh,
                              from_points=not (loader.cells_raster or "--host_raster" in flags),
                              from_cells=loader.cells_raster)
    timings = {}
    evaluate_map(infer, model, loader, iou_threshold=config.iou_thresh, timings=timings)
    return timings


def phase_evaluate(dev, root):
    """Phase 5: the port's `cli.evaluate.main` on the 16 synthetic val
    frames of `root` in the four configurations. Returns {label:
    launches}."""
    import os

    from complex_yolov4_tpu_torch.cli import evaluate

    launches, rows = {}, []
    check_points_raster(root, dev)
    check_oracle(root, dev)
    fns = counters()
    saved = os.environ.pop("FUSED_STAGE", None)
    try:
        for label, flags, fused in EVAL_CONFIGS:
            if fused:
                os.environ["FUSED_STAGE"] = "1"
            argv = ["--dataset_dir", root, "--model", MODEL, "--batch_size", str(BATCH),
                    "--compute_dtype", "bfloat16", "--conf_thresh", str(EVAL_CONF),
                    *flags]
            cold = {}
            for fn in fns.values():
                fn.launches = 0
            out, model = evaluate.main(argv, timings=cold)
            got = {k: fn.launches for k, fn in fns.items()}
            os.environ.pop("FUSED_STAGE", None)
            n_batches = len(cold["infer"])
            per_batch, want = expected_launches(model, n_batches,
                                                1 if "--quantize" in flags else 0)
            print(f"[eval] {label}: launches over {n_batches} batches {got}; "
                  f"per batch from model.routes(608) {per_batch}")
            if got != want or n_batches != EVAL_FRAMES // BATCH:
                raise AssertionError(f"{label} did not run through the kernels: {got} != {want}")
            if per_batch != (LAUNCHES_PATH2 if fused else LAUNCHES_PATH1):
                raise AssertionError(f"{label}: unexpected routes {per_batch}")
            if sum(cold["detections"]) == 0:
                raise AssertionError(f"{label}: no detection survived NMS at conf "
                                     f"{EVAL_CONF}; the mAP would be vacuous")
            launches[label] = got
            first, _ = eval_loader(root, flags)
            check_heads(label, model, next(iter(first)), dev)
            warm = warm_pass(model, root, argv, flags)
            host_ms, cap_ms = loader_ms(root, flags)
            rows.append((label, float(out["mAP"]), host_ms, cap_ms, cold, warm))
            del model
    finally:
        os.environ.pop("FUSED_STAGE", None)
        if saved is not None:
            os.environ["FUSED_STAGE"] = saved

    def ms(xs):
        return " ".join(f"{x * 1e3:.2f}" for x in xs)

    fps = {}
    for label, m_ap, host_ms, cap_ms, cold, warm in rows:
        fps[label] = EVAL_FRAMES / warm["total"][0]
        cap = "" if cap_ms is None else f" (+ capacity estimate {cap_ms:.2f} ms once)"
        print(f"[eval] {label}: mAP={m_ap:.4f} live detections={sum(cold['detections'])} "
              f"host_ms/batch (loader alone)={host_ms:.2f}{cap}")
        for name, t in (("cold", cold), ("warm", warm)):
            print(f"[eval] {label} {name}: device_ms/batch (raster..NMS, synced)="
                  f"{ms(t['infer'])} match_ms/batch={ms(t['match'])} "
                  f"wait_ms/batch={ms(t['load'])} eval frames/s={EVAL_FRAMES / t['total'][0]:.2f}")
    print("[eval] warm eval frames/s, points layout vs COO cells: "
          f"{fps['points']:.2f} vs {fps['cells']:.2f}")
    return launches


def fixed_batch_descent(state, batch):
    """12 Adam steps (LR 1e-3) of the trained state on one fixed batch: the
    losses, which must be finite and end lower than they start."""
    from complex_yolov4_tpu_torch import train as T

    step = T.make_train_step()
    losses = [float(step(state, batch, 1e-3, 0, False)["loss"]) for _ in range(12)]
    print(f"[train] 12 Adam steps (LR 1e-3) on one fixed batch of {TRAIN_BATCH}: loss "
          + " ".join(f"{v:.4g}" for v in losses))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"loss not finite or not falling on a fixed batch: {losses}")


def train_throughput(state, batch, dev):
    """Train images/s at 608, bf16, batch 4, on a warm state: TRAIN_WINDOWS
    windows of TRAIN_WINDOW_STEPS steps, each synced and timed on the host
    clock; then the device's busy share of PROFILED_STEPS steps
    (torch.profiler, CUDA activity only: the kernels' summed device time
    over the steps' wall time); then 3 steps split into synced stages
    (raster, forward, loss, backward, optimizer); and the peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from complex_yolov4_tpu_torch import train as T
    from complex_yolov4_tpu_torch.losses.yolo_loss import network_loss
    from complex_yolov4_tpu_torch.train.trainer import batch_images

    step = T.make_train_step()
    torch.cuda.reset_peak_memory_stats(dev)
    step(state, batch, 1e-4, 0, False)
    torch.cuda.synchronize()
    windows = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_WINDOW_STEPS):
            step(state, batch, 1e-4, 0, False)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / TRAIN_WINDOW_STEPS)
    step_s = float(np.mean(windows))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(state, batch, 1e-4, 0, False)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    model, opt = state.model, state.optimizer
    split = {k: [] for k in ("raster", "forward", "loss", "backward", "optimizer")}
    for _ in range(3):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        images = batch_images(batch, dev)
        targets = torch.as_tensor(batch["targets"], device=dev)
        tmask = torch.as_tensor(batch["target_mask"], device=dev)
        mark()
        heads = model(images)
        mark()
        loss, _ = network_loss(model.spec, heads, targets, tmask, want_metrics=False)
        mark()
        loss.backward()
        mark()
        opt.step()
        opt.zero_grad(set_to_none=True)
        mark()
        for k, a, b in zip(split, marks[:-1], marks[1:]):
            split[k].append((b - a) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    spread = (max(windows) - min(windows)) / min(windows)
    print(f"[train] {MODEL} @608 bf16 batch {TRAIN_BATCH}: {step_s * 1e3:.2f} ms/step over "
          f"{TRAIN_WINDOWS} windows of {TRAIN_WINDOW_STEPS} synced steps after the descent's "
          f"warm-up, train images/s={TRAIN_BATCH / step_s:.2f}; per window ms/step "
          + " ".join(f"{w * 1e3:.2f}" for w in windows)
          + f" (spread {spread * 100:.1f}%); peak memory {peak:.2f} GiB")
    if busy > 0:
        busy_step = busy / PROFILED_STEPS
        print(f"[train] device busy share: {busy_step:.2f} ms of kernels a step "
              f"({PROFILED_STEPS} profiled steps) = {busy_step / (step_s * 1e3):.3f} of the "
              f"timed windows' {step_s * 1e3:.2f} ms step; {busy / prof_wall:.3f} of the "
              f"profiled steps' own {prof_wall / PROFILED_STEPS:.2f} ms (the tracing slows "
              f"the host)")
    else:
        print("[train] device busy share: not measured (the profiler saw no device time)")
    print("[train] split of 3 steps, synced stages, ms: " + "; ".join(
        f"{k} {np.mean(v):.2f}" for k, v in split.items()))


def warm_rate(t, frames_per_batch):
    """Eval frames/s over the batches after the first (its loader wait and
    first calls left out): frames over the summed loader wait, inference
    and matching seconds of those batches."""
    rest = [sum(x) for x in zip(t["load"][1:], t["infer"][1:], t["match"][1:])]
    return frames_per_batch * len(rest) / sum(rest)


def phase_train(dev, tmp, root):
    """Phase 6: `cli.train.main` on the synthetic train tree `root` (its
    working directory under `tmp`), then its checkpoint in
    `cli.evaluate.main` (f32, and int8 in f32 compute), a fixed-batch
    descent and the train throughput on the trained state. Returns {label:
    launches} of its f32 runs."""
    import os

    from complex_yolov4_tpu_torch.cli import evaluate, train
    from complex_yolov4_tpu_torch.data import loader as ld
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.network import kernel_routes

    fns = counters()
    launches = {}
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] phase 6 {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    spec_routes = kernel_routes(zoo.get_model_spec(MODEL), 608, torch.float32)
    per_val_batch = sum(1 for r in spec_routes.values() if r == "conv3x3")
    val_batches = -(-TRAIN_VAL_FRAMES // TRAIN_BATCH)
    argv = ["--dataset_dir", root, "--model", MODEL, "--batch_size", str(TRAIN_BATCH),
            "--subdivisions", str(TRAIN_SUBDIV), "--num_epochs", "1",
            "--working_dir", os.path.join(tmp, "train_wd"), "--print_freq", "1",
            "--checkpoint_freq", "1", "--conf_thresh", str(EVAL_CONF)]
    for fn in fns.values():
        fn.launches = 0
    timings = {}
    t0 = time.perf_counter()
    state = train.main(argv, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in fns.items()}
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["conv3x3_fused"] = per_val_batch * val_batches
    n_steps = len(timings["step"])
    print(f"[train] cli.train: {MODEL} @608 bf16 batch {TRAIN_BATCH}, subdivisions "
          f"{TRAIN_SUBDIV}: {n_steps} micro-batches, {state.global_step // TRAIN_SUBDIV} "
          f"optimizer steps, step ms (host, first pays first-use costs) "
          + " ".join(f"{x * 1e3:.1f}" for x in timings["step"])
          + f"; f32 validation mAP={timings['mAP'][0]:.4f} in {timings['val'][0]:.2f} s; "
          f"whole run {wall:.1f} s; launches {got} (validation: {per_val_batch} f32 3x3 "
          f"launches per batch from the f32 routes {spec_routes}, {val_batches} batches)")
    if (n_steps != TRAIN_FRAMES // TRAIN_BATCH or state.global_step != n_steps
            or got != want):
        raise AssertionError(f"train run: {n_steps} steps, launches {got} != {want}")
    launches["train (f32 validation)"] = got
    ckpt = os.path.join(tmp, "train_wd", "checkpoints", "complexer_yolo", "epoch_1.ckpt")
    lap("cli.train")

    # the checkpoint in cli.evaluate, with its default f32 compute
    eval_argv = ["--dataset_dir", root, "--model", MODEL, "--batch_size", str(BATCH),
                 "--conf_thresh", str(EVAL_CONF), "--pretrained_path", ckpt]
    for fn in fns.values():
        fn.launches = 0
    cold = {}
    out, model = evaluate.main(eval_argv, timings=cold)
    got = {k: fn.launches for k, fn in fns.items()}
    n_batches = len(cold["infer"])
    per_batch, want = expected_launches(model, n_batches, 0)
    print(f"[train] checkpoint in cli.evaluate (f32, {TRAIN_VAL_FRAMES} frames, batch "
          f"{BATCH}): mAP={float(out['mAP']):.4f} launches {got}, per batch from "
          f"model.routes(608) {per_batch}; device_ms/batch "
          + " ".join(f"{x * 1e3:.2f}" for x in cold["infer"])
          + f"; eval frames/s (cold, every batch)={TRAIN_VAL_FRAMES / cold['total'][0]:.2f}")
    if (got != want or model.compute_dtype != torch.float32 or per_batch["stem_conv3x3"]
            or n_batches != TRAIN_VAL_FRAMES // BATCH):
        raise AssertionError(f"f32 eval of the checkpoint: {got} != {want}")
    ref = state.model.to_serving(dev, torch.float32)
    for name, buf in ref.named_buffers():
        if not torch.equal(buf, getattr(model, name)):
            raise AssertionError(f"checkpoint weights differ from the trained model: {name}")
    del ref
    launches["eval f32 checkpoint"] = got
    first, _ = eval_loader(root, ())
    check_heads("f32 checkpoint", model, next(iter(first)), dev, rel_tol=F32_HEADS_TOL,
                prob_tol=F32_HEADS_TOL)
    warm = warm_pass(model, root, eval_argv, ())
    print(f"[train] f32 eval warm pass: device_ms/batch "
          + " ".join(f"{x * 1e3:.2f}" for x in warm["infer"])
          + " match_ms/batch " + " ".join(f"{x * 1e3:.2f}" for x in warm["match"])
          + " wait_ms/batch " + " ".join(f"{x * 1e3:.2f}" for x in warm["load"])
          + f"; eval frames/s over batches 2-{len(warm['infer'])} "
          f"({TRAIN_VAL_FRAMES - BATCH} frames, the first batch left out)="
          f"{warm_rate(warm, BATCH):.2f}")
    del model
    lap("f32 eval of the checkpoint")

    # the checkpoint served int8 in f32 compute (calibrated in f32, the
    # int8 convs writing f32)
    for fn in fns.values():
        fn.launches = 0
    cold_i8 = {}
    out_i8, model_i8 = evaluate.main(eval_argv + ["--quantize", "int8", "--calib_batches",
                                                  "1", "--num_samples", str(BATCH)],
                                     timings=cold_i8)
    got = {k: fn.launches for k, fn in fns.items()}
    per_batch, want = expected_launches(model_i8, len(cold_i8["infer"]), 1)
    print(f"[train] checkpoint in cli.evaluate --quantize int8 (f32 compute, the first "
          f"{BATCH} frames): "
          f"mAP={float(out_i8['mAP']):.4f} launches {got}, per batch from "
          f"model.routes(608) {per_batch} plus the f32 calibration batch; device_ms/batch "
          + " ".join(f"{x * 1e3:.2f}" for x in cold_i8["infer"])
          + f"; eval frames/s (cold, every batch)="
          f"{BATCH / cold_i8['total'][0]:.2f}")
    if (got != want or per_batch["int8_conv"] != 68
            or {kw.get("out") for kw in model_i8._int8_kw.values()} != {"f32", "int8"}):
        raise AssertionError(f"int8 f32 eval of the checkpoint: {got} != {want}")
    launches["eval int8 f32 checkpoint"] = got
    del model_i8
    lap("int8 f32 eval of the checkpoint")

    loader = ld.create_train_loader(root, TRAIN_BATCH, device_raster=True)
    loader.set_epoch(1)
    batch = next(iter(loader))
    torch.cuda.empty_cache()
    fixed_batch_descent(state, batch)
    lap("fixed-batch descent")
    train_throughput(state, batch, dev)
    del state
    torch.cuda.empty_cache()
    lap("train throughput")
    return launches

def make_trees(tmp):
    """The synthetic KITTI trees of phases 5-7 under `tmp` (the port's
    generator): 16 val frames (seed 0; phase 5, phase 7's native checks),
    16 train and 24 val frames (seed 1; phase 6, phase 7's mosaic check),
    48 train frames (seed 3; phase 7's --mosaic run and remat), 48 test
    frames (seed 2; phase 7's cli.test)."""
    import os

    from complex_yolov4_tpu_torch.data import synthetic

    return {"eval": synthetic.generate_kitti_dataset(
                os.path.join(tmp, "eval_kitti"), num_train=0, num_val=EVAL_FRAMES,
                num_test=0, seed=0),
            "train": synthetic.generate_kitti_dataset(
                os.path.join(tmp, "train_kitti"), num_train=TRAIN_FRAMES,
                num_val=TRAIN_VAL_FRAMES, num_test=0, seed=1),
            "mosaic": synthetic.generate_kitti_dataset(
                os.path.join(tmp, "mosaic_kitti"), num_train=MOSAIC_FRAMES, num_val=0,
                num_test=0, seed=3),
            "test": synthetic.generate_kitti_dataset(
                os.path.join(tmp, "test_kitti"), num_train=0, num_val=0,
                num_test=TEST_FRAMES, seed=2)}


def host_side(tmp):
    """What runs on the card's host while nvcc builds the kernels (phase 2):
    the trees (`make_trees`) and phase 4's raw scenes, and phase 7 (a) g++
    builds the native host rasterizer (any failure fails the run: no numpy
    fallback here), then (b) and (d) hold it bit for bit against the numpy
    functions (`native_checks`). Nothing here is timed as a measurement: nvcc shares
    the host. Returns the trees' roots."""
    from complex_yolov4_tpu_torch import native

    t0 = time.perf_counter()
    roots = make_trees(tmp)
    for r in range(-1, REQUESTS):
        raw_scenes(r)
    t1 = time.perf_counter()
    so = native.build()
    native.load()
    t2 = time.perf_counter()
    print(f"[native] {so.name} built by g++ in {t2 - t1:.1f} s, beside nvcc (the trees "
          f"and phase 4's scenes took {t1 - t0:.1f} s)")
    native_checks(roots["eval"], roots["train"])
    print(f"[time] phase 7 (a, b, d: native build and checks, beside nvcc): "
          f"{time.perf_counter() - t1:.1f} s")
    return roots


def native_checks(eval_root, train_root):
    """Phase 7 (b) and (d): on the 16 val frames of phase 5's tree, the
    native `rasterize_points`, `aggregate_cells` and `rasterize_files`
    against the numpy `make_bev_map`, `aggregate_bev_cells` and per-frame
    rasters, bit for bit; on phase 6's train frames, the fused native mosaic
    against the numpy canvas after `resize_linear` (within 1e-6; how many
    are bit-equal is printed), with equal targets, masks and RNG state."""
    import glob
    import os

    from complex_yolov4_tpu_torch import native
    from complex_yolov4_tpu_torch.data import bev, loader as ld
    from complex_yolov4_tpu_torch.data.dataset import KittiDataset
    from complex_yolov4_tpu_torch.data.kitti import read_velodyne
    from complex_yolov4_tpu_torch.data.transforms import (default_aug_transforms,
                                                          default_lidar_transforms)

    paths = sorted(glob.glob(os.path.join(eval_root, "training", "velodyne", "*.bin")))
    if len(paths) != EVAL_FRAMES:
        raise AssertionError(f"phase 5's tree has {len(paths)} frames")
    rasters = []
    for path in paths:
        pts = read_velodyne(path)
        cropped = bev.remove_points_outside(pts)
        got, (cells, keys) = native.rasterize_points(pts), native.aggregate_cells(pts)
        c_ref, k_ref = bev.aggregate_bev_cells(cropped)
        if not (np.array_equal(got, bev.make_bev_map(cropped)) and np.array_equal(cells, c_ref)
                and np.array_equal(keys, k_ref)):
            raise AssertionError(f"native raster or COO differs from numpy on {path}")
        rasters.append(got)
    if not np.array_equal(native.rasterize_files(paths), np.stack(rasters)):
        raise AssertionError("rasterize_files differs from per-frame rasterize_points")
    print(f"[host] native vs numpy on {EVAL_FRAMES} frames: rasterize_points == "
          f"make_bev_map(remove_points_outside), aggregate_cells == aggregate_bev_cells, "
          f"rasterize_files == per-frame rasters, bit for bit ok")

    ds = KittiDataset(train_root, mode="train", lidar_transforms=default_lidar_transforms(),
                      aug_transforms=default_aug_transforms(0.5, cutout_prob=0.5,
                                                            cutout_fill_value=0.25),
                      mosaic=True, random_padding=True)
    worst, bitwise = 0.0, 0
    for seed, index in MOSAIC_PAIRS:
        index %= len(ds)
        rng_n, rng_p = np.random.default_rng((11, seed)), np.random.default_rng((11, seed))
        _, fused, t_n, m_n = ds._load_mosaic_native(index, rng_n)
        _, canvas, t_p, m_p = ds._load_mosaic_python(index, rng_p)
        ref = ld.resize_linear(canvas, 608)
        err = float(np.abs(fused - ref).max())
        worst, bitwise = max(worst, err), bitwise + int(np.array_equal(fused, ref))
        if not (err <= 1e-6 and np.array_equal(t_n, t_p) and np.array_equal(m_n, m_p)
                and rng_n.bit_generator.state == rng_p.bit_generator.state):
            raise AssertionError(f"mosaic (seed {seed}, index {index}): native vs numpy "
                                 f"max err {err}, targets or RNG state differ")
    n = len(MOSAIC_PAIRS)
    print(f"[host] fused native mosaic vs numpy canvas + resize_linear, {n} (seed, index) "
          f"pairs: max abs err {worst:.3g} (tol 1e-6), {bitwise} of {n} bit-equal, targets, "
          f"masks and RNG state equal ok")


def mosaic_loader_ms(root):
    """Host ms per micro-batch of the mosaic train loader alone (no prefetch
    thread, the frame pool on), the epoch's batches of TRAIN_BATCH."""
    from complex_yolov4_tpu_torch.data import loader as ld

    loader = ld.create_train_loader(root, TRAIN_BATCH, mosaic=True, hflip_prob=0.5, seed=SEED)
    loader.set_epoch(1)
    loader.prefetch = 0
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) / n * 1e3


def remat_check(state, batch, dev):
    """Phase 7 (f): two bf16 steps on one fixed batch from the same state,
    without and with --remat: losses within REMAT_LOSS_REL relative, BN
    running statistics within bf16 rounding (2^-8 of each leaf's max), and
    the peak memory of each; remat's must be lower. Then REMAT_TIMED_STEPS
    further synced steps of each give its ms/step."""
    from complex_yolov4_tpu_torch import train as T

    model, opt = state.model, state.optimizer
    snap_m = {k: v.clone() for k, v in model.state_dict().items()}
    snap_o = copy.deepcopy(opt.state_dict())
    runs = {}
    for remat in (False, True):
        model.load_state_dict(snap_m)
        # a copy: the optimizer takes the tensors of the dict it loads as its
        # own state and updates them in place
        opt.load_state_dict(copy.deepcopy(snap_o))
        step = T.make_train_step(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = [float(step(state, batch, 1e-4, 0, False)["loss"]) for _ in range(2)]
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REMAT_TIMED_STEPS):
            step(state, batch, 1e-4, 0, False)
        torch.cuda.synchronize()
        runs[remat] = (losses, (time.perf_counter() - t0) / REMAT_TIMED_STEPS,
                       torch.cuda.max_memory_allocated(dev) / 2 ** 30, stats)
    (l0, s0, m0, b0), (l1, s1, m1, b1) = runs[False], runs[True]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    stat_rel = max(float((b1[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                   for k, v in b0.items())
    ok = (loss_rel <= REMAT_LOSS_REL and stat_rel <= 2.0 ** -8 and m1 < m0
          and all(np.isfinite(l0 + l1)))
    print(f"[train7] --remat, 2 steps from one state on one batch of {TRAIN_BATCH}: losses "
          f"{' '.join(f'{x:.6g}' for x in l0)} plain, {' '.join(f'{x:.6g}' for x in l1)} remat "
          f"(max rel diff {loss_rel:.3g}, tol {REMAT_LOSS_REL}); BN running statistics max rel "
          f"diff {stat_rel:.3g} (tol 2^-8); peak memory {m0:.2f} GiB plain, {m1:.2f} GiB remat; "
          f"ms/step (synced over {REMAT_TIMED_STEPS} further steps) {s0 * 1e3:.1f} plain, "
          f"{s1 * 1e3:.1f} remat (x{s1 / s0:.2f}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("--remat: losses, statistics or peak memory off")


def phase_train_flags(dev, tmp, train_root):
    """Phase 7 (e)-(g): `cli.train.main --mosaic` with one profiled step
    (complex_yolov4 @608 bf16, batch 4, --subdivisions 2, no validation) on
    the MOSAIC_FRAMES train frames of `train_root`, then --remat on its
    state. Returns the
    launches of the training run (none: training runs no hand kernel)."""
    import glob
    import os

    from complex_yolov4_tpu_torch.cli import train
    from complex_yolov4_tpu_torch.data import loader as ld

    fns = counters()
    wd = os.path.join(tmp, "mosaic_wd")
    argv = ["--dataset_dir", train_root, "--model", MODEL, "--batch_size", str(TRAIN_BATCH),
            "--subdivisions", str(TRAIN_SUBDIV), "--num_epochs", "1", "--working_dir", wd,
            "--print_freq", "1", "--no_val", "--mosaic", "--profile_steps", "1",
            "--profile_start", "1"]
    for fn in fns.values():
        fn.launches = 0
    timings = {}
    t0 = time.perf_counter()
    state = train.main(argv, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in fns.items()}
    traces = glob.glob(os.path.join(wd, "logs", "complexer_yolo", "*.pt.trace.json"))
    n = len(timings["step"])
    # the micro-batches after the profiled one (index 1): loader wait, step and
    # the print window's loss read (which waits for the card), per iteration
    tail = timings["iter"][2:]
    rate = TRAIN_BATCH * len(tail) / sum(tail) if tail else float("nan")
    alone = mosaic_loader_ms(train_root)
    print(f"[train7] cli.train --mosaic (fused native mosaic, host raster), {MODEL} @608 bf16 "
          f"batch {TRAIN_BATCH}, subdivisions {TRAIN_SUBDIV}: {n} micro-batches, losses finite "
          f"{bool(np.isfinite(timings['loss']).all())}; iteration ms "
          + " ".join(f"{x * 1e3:.1f}" for x in timings["iter"])
          + " (the first pays first-use costs, the second is profiled); loader wait ms "
          + " ".join(f"{x * 1e3:.1f}" for x in timings["load"])
          + f"; train images/s over micro-batches 3-{n} = {rate:.2f}; mosaic loader alone "
          f"{alone:.2f} ms per micro-batch of {TRAIN_BATCH}; whole run {wall:.1f} s; "
          f"launches {got}")
    print(f"[train7] --profile_steps 1 --profile_start 1: trace files "
          f"{[os.path.basename(t) for t in traces]} "
          f"({sum(os.path.getsize(t) for t in traces) / 2 ** 20:.1f} MiB)")
    if (n != MOSAIC_FRAMES // TRAIN_BATCH or not np.isfinite(timings["loss"]).all()
            or any(got.values())):
        raise AssertionError(f"mosaic train run: {n} steps, losses {timings['loss']}, "
                             f"launches {got}")
    if len(traces) != 1:
        raise AssertionError(f"--profile_steps left {len(traces)} trace files")
    loader = ld.create_train_loader(train_root, TRAIN_BATCH, mosaic=True, seed=SEED)
    loader.set_epoch(1)
    loader.prefetch = 0
    remat_check(state, next(iter(loader)), dev)
    del state
    torch.cuda.empty_cache()
    return got


def phase_test_cli(dev, tmp, root):
    """Phase 7 (h): `cli.test.main` on the TEST_FRAMES synthetic test frames of
    `root`, complex_yolov4 @608 bf16 batch 8, points raster, the launch
    counts set to 0 just before: per batch the routes' stem and 3x3
    launches. Returns the launches."""
    import os

    from complex_yolov4_tpu_torch.cli import test
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.network import kernel_routes

    routes = kernel_routes(zoo.get_model_spec(MODEL), 608, torch.bfloat16)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    timings = {}
    results = test.main(["--dataset_dir", root, "--model", MODEL, "--batch_size", str(BATCH),
                         "--working_dir", os.path.join(tmp, "test_wd")], timings=timings)
    got = {k: fn.launches for k, fn in fns.items()}
    n_batches = len(results)
    want = {k: v * n_batches for k, v in LAUNCHES_PATH1.items()}
    finite = all(np.isfinite(d).all() for _, d, _ in results)
    live = [int(m.sum()) for _, _, m in results]
    per_frame = [t / BATCH * 1e3 for t in timings["infer"]]
    warm = sum(timings["infer"][1:]) / (BATCH * (n_batches - 1)) * 1e3
    print(f"[test] cli.test: {MODEL} @608 bf16, batch {BATCH}, {TEST_FRAMES} test frames, "
          f"points raster: {n_batches} batches, launches {got} (per batch "
          f"{LAUNCHES_PATH1}, routes {routes}); detections finite {finite}, live per batch "
          f"{live}; ms/frame (inference, synced) cold {per_frame[0]:.2f} (the first batch), "
          f"warm " + " ".join(f"{x:.2f}" for x in per_frame[1:])
          + f"; frames/s cold {1e3 / per_frame[0]:.2f}, warm "
          + " ".join(f"{1e3 / x:.2f}" for x in per_frame[1:])
          + f"; warm over batches 2-{n_batches} ({BATCH * (n_batches - 1)} frames): "
          f"{warm:.2f} ms/frame, {1e3 / warm:.2f} frames/s (inference only, the loader "
          f"excluded)")
    if (got != want or n_batches != TEST_FRAMES // BATCH or not finite
            or sum(1 for r in routes.values() if r == "stem") != LAUNCHES_PATH1["stem_conv3x3"]):
        raise AssertionError(f"cli.test: launches {got} != {want}, or non-finite detections")
    return got


def main() -> None:
    t_start = clock = time.perf_counter()

    def lap(what):
        nonlocal clock
        now = time.perf_counter()
        print(f"[time] {what}: {now - clock:.1f} s")
        clock = now

    name, count, smi = phase_device()
    dev = torch.device("cuda", 0)
    # the first torch.optim optimizer (phase 6) imports torch._dynamo, seconds
    # of host time: import it while nvcc builds; g++ builds the native host
    # rasterizer (phase 7) meanwhile too
    dynamo = threading.Thread(target=importlib.import_module, args=("torch._dynamo",),
                              daemon=True)
    dynamo.start()
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_dir.name
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(host_side, tmp)
        phase_build()
        roots = host.result()  # raises if g++ failed or a native check did
    dynamo.join()
    lap("phases 1-2 (device, build; phase 7 a, b, d beside it)")
    records = phase_kernels(dev)
    lap("phase 3 (stem and 3x3 kernels)")
    records["fused_stage"] = phase_fused(dev)
    lap("phase 3 (fused stage)")
    records["int8_conv"], records[INT8_F32_ROW] = phase_int8(dev)
    lap("phase 3 (int8 conv)")
    spec, path1, path2 = build_models(dev)
    l1 = serve_path("path 1 (bf16)", spec, path1, LAUNCHES_PATH1, BATCH, dev)
    layerwise_segments(path1, dev)
    l2 = serve_path("path 2 (int8 + fused stages)", spec, path2, LAUNCHES_PATH2, 2, dev)
    if "--split" in sys.argv[1:]:
        phase_split("path1", path1, dev)
        phase_split("path2", path2, dev)
    del path1, path2
    torch.cuda.empty_cache()
    lap("phase 4 (slice; phase 7 c: served with numpy and native COO)")
    try:
        runs = {"serve path 1": l1, "serve path 2": l2,
                **{f"eval {k}": v for k, v in phase_evaluate(dev, roots["eval"]).items()}}
        lap("phase 5 (evaluate)")
        f32_runs = phase_train(dev, tmp, roots["train"])
        lap("phase 6 (train)")
        runs["train mosaic"] = phase_train_flags(dev, tmp, roots["mosaic"])
        lap("phase 7 (e-g: mosaic training, profiler, remat)")
        runs["test cli"] = phase_test_cli(dev, tmp, roots["test"])
        lap("phase 7 (h: cli.test)")
    finally:
        tmp_dir.cleanup()
    print(f"[time] phases 1-7: {time.perf_counter() - t_start:.1f} s")
    kernels = []
    f32_of = {F32_ROW: "conv3x3_fused", INT8_F32_ROW: "int8_conv"}
    for k in KERNEL_NAMES + tuple(f32_of):
        r = records[k]
        launches = (sum(run[f32_of[k]] for run in f32_runs.values()) if k in f32_of
                    else sum(run[k] for run in runs.values()))
        row = {
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if 2 * r["bytes_bound_ms"] >= r["bound_ms"] else "operations",
            "library_ms": r["library_ms"]}
        if "library_layers" in r:
            row.update(library_layers=r["library_layers"],
                       ms_on_library_layers=r["ms_on_library_layers"])
        kernels.append(row)
    print("[kernels] launches per run: " + "; ".join(
        f"{name} {run}" for name, run in {**runs, **f32_runs}.items()))
    print("[kernels] launches: the bf16 runs of phases 4, 5 and 7 together, and for "
          f"{F32_ROW} and {INT8_F32_ROW} the f32 runs of phase 6; ms, plain_ms, bound_ms and "
          "library_ms: per request of 8 frames, summed over the main-path layers each kernel "
          "takes (3x3 in bf16 and f32: layers 1, 6, 11, 16, 19; fused stage: segments 2-10 and "
          "12-23; int8: "
          "the 68 quantized convs, but library_ms over its library_layers 1x1 convs only, "
          "on which the kernel takes ms_on_library_layers); bound_by: what bounds the layers "
          "holding most of bound_ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
