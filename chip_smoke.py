"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --split    # also each path's stage split and profile

Phases (any failure raises and the run exits non-zero; there is no CPU
fallback):

1. device — the card's name, count, and `nvidia-smi` name and power limit;
2. build — nvcc builds the kernels from complex_yolov4_tpu_torch/csrc/
   (sm_90a, one nvcc per source or source part, in parallel) and each
   unit's seconds and its -Xptxas -v register / shared-memory lines are
   printed;
3. kernel vs plain, each on the same inputs as its plain PyTorch version,
   timed with CUDA events (plain, kernel, kernel, plain):
   - the stem kernel at (8, 608, 608, 3 -> 32) and the 3x3 kernel at the
     five complex_yolov4 main-path shapes (batch 8): at most 1 bf16 ulp
     apart (values below 2^-10 of the tensor's largest, where the f32 sum
     cancels, are held to the ulp of that floor);
   - the 3x3 kernel's f32 contract (f32 x rounded to bf16 for the
     products, f32 out: `pallas_conv.py` on an f32 x) at the same five
     shapes: within 1e-4 of max |plain| (both round to bf16 the same way;
     only the summation order differs), each layer's kernel_ms printed
     against its own bound; its library_ms is one f32 cuDNN `F.conv2d`
     with TF32 off, as the port's f32 path runs;
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
     launch cost). Then the int8 conv as f32 compute runs it: an f32 input
     on the non-chained convs (quantized in the kernel: its int32 sums
     equal, its f32 output within 1e-5) and int8 on the chained ones, int8
     out on the chained convs and f32 out on the rest, beside the route
     before the kernel took an f32 input (the plain `quantize_input` pass,
     then the kernel from its int8 x) on the same inputs, both eager and
     device, with the f32 route's own bound (f32 in and out bytes) and its
     own time on the 1x1 layers beside `torch._int_mm`;
   - the rotated NMS kernel (`csrc/nms.cu`) at the served shape: 16
     frames of complex_yolov4's 22,743 decoded boxes at 608, k = 64, conf
     0.5, nms 0.5, on heads jittered around 12 centres a frame, against
     `nms_batch_plain` on the same heads: keep masks equal in every frame
     that holds no same-class pair whose plain IoU lies within 1e-5 of the
     threshold, rows within 1e-5 relative; eager kernel_ms (host launch
     included) beside its device time (CUDA-graph replay) and its launches
     a call;
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
     null, with the reason printed, for the int8 3x3 layers, the fused
     stage and the NMS, which no single PyTorch call computes. A kernel slower than
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
   on both paths the NMS kernel launches twice per request;
   on each path the decoded heads of the kernel path are compared with the
   all-plain path on the card (path 2 at batch 2: the plain int8 convs run
   in float64);
   (s) sighted checks: the seed-0 weights carry almost nothing of the
   input to the heads (a layer of the early backbone zeroed moves them by
   about 1e-6), so both paths and the f32 3x3 route are built again from
   `sighted.sighted_params_np` (every conv rescaled to unit RMS on one
   synthetic raster) and their kernel path held to their all-plain path
   on 2 frames (SIGHTED_CHECKS: the heads of path 1, path 2 and f32 with
   the route on, on `rms_err`; path 2 through layer 25 on `rms_err` and
   through layer 85 on `share_moved`), each tolerance 1.5x the largest
   floor measured on the card (the all-plain path against the same path
   with the routed stem and 3x3 layers on cuDNN and the fused segments
   layer by layer), the floor printed beside it; then planted faults (the
   stem's, layer 1's, layer 8's in fused segment 2-10 and the first int8
   conv's weights zeroed in the kernel path's buffers; for layer 85 the
   int8 convs 25, 27, 55 (strided) and 59 and 62 (chained)) must move
   each check by at least 10x its tolerance (path 2's heads 2x, see
   SIGHTED_CHECKS), the seed-0 head check's move
   printed beside it; then the f32 route: the default f32 forward (every
   conv cuDNN f32, TF32 off) against the CPU's f32 forward of the same
   sighted model within 1e-4 per column, and the 3x3 route
   (`conv3x3.F32_ENABLED`) against the default, per head column;
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
   counts set to 0 just before: training and the all-f32 validation
   launch no kernel. Then the checkpoint is served by `cli.evaluate.main`
   with its default f32 compute (the weights checked equal to the trained
   module's, no launch, and f32 eval frames/s of a warm pass over 3
   batches of 8, the first left out), again with the f32 3x3 route
   switched on (`conv3x3.F32_ENABLED`: the 3x3 kernel's f32 instance as
   `model.routes(608)` predicts, the decoded heads of 2 frames within 1e-3
   of the all-plain f32 path, its mAP beside the default's, and its warm
   frames/s), and again, on its first 8 frames, with
   `--quantize int8` in f32 compute (calibrated in f32; the int8 convs
   write f32, or int8 where chained, 68 int8 launches per batch; the
   kernel quantizes each f32 input, so the plain `quantize_input` pass
   must never run). Then, on the trained state: 12
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
8. data parallel (`complex_yolov4_tpu_torch.parallel`: one process per
   device) — one card holds every rank here: NCCL refuses two ranks on one
   device, so the NCCL group is checked at world size 1 and the two-rank
   arithmetic over gloo, which carries CUDA tensors through the host (the
   backend chosen in the library call, never as a fallback).
   (a) an NCCL group of one rank: complex_yolov4 @608, f32 with TF32 off,
   the global batch of 4 below, one SGD step under `parallel.wrap_ddp`
   against the plain step from the same state: the loss and the running
   BN statistics within 1e-4 (the CPU test's bounds,
   tests/test_torch_port_ddp.py); the parameters' step (relative L2 over
   all leaves) and max |param diff| within 2x the plain step's own noise
   floor, taken in the same run by the plain step on its input scaled by
   1 + 1e-7, 1 - 1e-7 and 1 + 1e-6 (at 608 this random net's gradient
   moves by percents under such rounding: DDP_FLOOR_MARGIN);
   (b) two processes sharing the card over gloo (`--ddp-rank`, started
   beside nvcc in phase 2 at the lowest CPU priority, where they join their
   group, build the weights and import what the optimizer needs, then wait
   for phase 8; each wait
   bounded, the processes killed at a failure or their time limit; (a)
   waits until (b) is done, so that (b)'s ms are the pair's own),
   complex_yolov4 @608 full width, batch 2
   per rank of a global batch of 4 uniform rasters with 3 targets each,
   one SGD step against one process on the batch of 4: f32 (TF32 off) at
   (a)'s bounds and floor; bf16 with the loss within 1e-2 relative, the BN
   statistics no further (relative L2 over all leaves) from the 1-process
   bf16 step's than those lie from the f32 step's, and the step's L2 norm
   within 1.5x of the 1-process bf16 step's (the bf16 step itself is
   rounding noise at 608: DDP_BF16_NORM); each
   rank's step ms (the compared step and 2 more, synced) and peak memory;
   (c) inside phase 4: path 1 over `make_inference_fn(devices=[cuda:0,
   cuda:0])`, 2 requests of 8 in the batched COO layout split 4 + 4, the
   launch counts set to 0 just before: stem 1 and 3x3 5 per replica per
   request, detections equal bit for bit to the one-device function's on
   each replica's 4 frames (those of the one-device batch of 8 printed
   beside them);
   (d) in the same two processes, `cli.train.main --num_processes 2` over
   their gloo group on 8 frames of phase 6's tree (complex_yolov4 @608
   bf16, batch 2 per rank, --subdivisions 2: 2 micro-batches per rank),
   the counts set to 0 just before: equal steps on both ranks, the lead's
   f32 validation of the 24 val frames through the 3x3 kernel's f32
   instance (5 launches per batch of 2), no launch on rank 1, one log and
   one checkpoint, the lead's.
9. export and tools (complex_yolov4 @608, full width, seed-0 weights) —
   four processes of their own (`--export-pt2`, one a job, started
   beside nvcc at the lowest CPU priority and waited for before phase 3,
   so that they time no host work: tracing runs the custom ops' fake
   implementations and needs no kernel) each build the weights once; three
   trace and save with `cli.export.export_pt2`, what `cli.export --format
   pt2` runs before its round trip, (a) the image input and (b) the points
   input (20480 a frame), and the same with FUSED_STAGE=1, each at batch 8
   with phase 4's thresholds (conf 0.5, nms 0.5, k=64); the fourth (c)
   writes `--format darknet` and `--format ckpt` (`write_weights`), each
   read back through `cli.common.load_weights` and held equal to the
   weights; each prints its seconds by step (imports, weights, trace,
   save, write, read), when it began and ended, and each file's MB.
   Then a fresh process (`--serve-pt2`) that imports torch and the port's
   ops only loads the three `.pt2` files (timed; the export's round trip)
   and serves phase 4's 8 requests as rasters (image) and phase 5's 16 val
   frames as padded points, the launch counts set to 0 after a warm-up
   call: stem 1 and 3x3
   5 per call, and with fused stages stem 1, 3x3 2 and fused stage 2. Its
   detections are held to the eager `make_inference_fn` on the same weights
   and inputs (the eager fused path for the fused artifact): keep sets
   equal, boxes within 1e-3 px, and whether they are bit-equal is printed,
   with the ms per batch (synced) of the loaded program beside eager's
   over the same batches, each timed alone. (d) `cli.find_anchors` on
   phase 6's train frames with `--device cuda` against `--device cpu`:
   anchors within 1e-4, avg IoU within 1e-4.

Each phase prints its wall time on a `[time]` line.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record (launches: the sum over the served, evaluated
and tested runs of phases 4, 5, 7, 8 (c) and 9 (the exported programs'
calls in the serving process), the f32 rows' over the f32 runs of phases
6 and 8 (d)), and the line before that nvidia-smi's name and power limit.
"""

from __future__ import annotations

import contextlib
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
# phase 4 (s), sighted checks, kernel path against all-plain path on the
# first 2 frames of request 0: {label: (model, layer the check reads or None
# for the decoded heads, statistic (`rms_err`, or `share_moved`: the share
# of elements that moved by more than half the RMS), tolerance on it,
# planted faults it takes, their least move in tolerances)}. Each tolerance
# is 1.5x the largest floor (the all-plain path against `cudnn_routed`)
# over 6 requests (3 for the layer checks) on an NVIDIA H100 80GB HBM3 at
# 700 W: `rms_err` path 1 0.0188-0.0229, path 2 0.152-0.157, path 2 at
# layer 25 0.0283-0.0287, f32 1.98e-4-2.81e-4; `share_moved` path 2 at
# layer 85 2.75e-4-7.53e-4. Path 2's `rms_err` sits 15% apart at the heads
# and 10% from layer 56 on between two correct implementations: a one-ulp
# difference upstream flips int8 steps (the int8 strided 3x3 at 55 doubles
# it), and a fault moves `rms_err` by 1.0 at most, so its heads need 2x;
# the 10x is asked of path 2 through layer 25, which holds all four
# kernels (stem, 3x3 on layers 1 and 11, both fused segments, the first
# int8 conv), and through layer 85, the end of the backbone's 38-px stage,
# by `share_moved`: a flipped int8 step moves an element by a fraction of
# the RMS, a zeroed layer moves most elements by more than half of it; it
# holds the int8 convs of layers 25-85, the strided one and the first
# chained ones (int8 out, scale handed on) among them.
SIGHTED_CHECKS = {"path 1": ("path 1", None, "rms_err", 0.035, ("stem", "3x3"), 10.0),
                  "path 2": ("path 2", None, "rms_err", 0.24,
                             ("stem", "3x3", "fused 2-10", "int8"), 2.0),
                  "path 2 to layer 25": ("path 2", 25, "rms_err", 0.043,
                                         ("stem", "3x3", "fused 2-10", "int8"), 10.0),
                  "path 2 to layer 85": ("path 2", 85, "share_moved", 1.13e-3,
                                         ("int8", "int8 27", "int8 strided 55",
                                          "int8 chained 59", "int8 chained 62"), 10.0),
                  "f32": ("f32", None, "rms_err", 4.3e-4, ("3x3",), 10.0)}
# the layers whose conv weights the planted faults zero
FAULT_LAYERS = {"stem": 0, "3x3": 1, "fused 2-10": 8, "int8": 25, "int8 27": 27,
                "int8 strided 55": 55, "int8 chained 59": 59, "int8 chained 62": 62}
# the default f32 forward on the card (all cuDNN f32, TF32 off) against the
# CPU's f32 forward of the same sighted model, per column relative and
# conf/cls absolute
F32_ROUTE_TOL = 1e-4
MODEL = "complex_yolov4"
# kernel launches per request. Path 1: layer 0 -> stem, layers 1, 6, 11,
# 16, 19 -> conv3x3. Path 2: layer 0 -> stem, layers 1, 11 -> conv3x3,
# layers 2-10 and 12-23 -> two fused-stage launches, 68 convs -> int8.
# Both: the NMS kernel's two launches.
LAUNCHES_PATH1 = {"stem_conv3x3": 1, "conv3x3_fused": 5, "fused_stage": 0, "int8_conv": 0,
                  "nms": 2}
LAUNCHES_PATH2 = {"stem_conv3x3": 1, "conv3x3_fused": 2, "fused_stage": 2, "int8_conv": 68,
                  "nms": 2}
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
KERNEL_NAMES = ("stem_conv3x3", "conv3x3_fused", "fused_stage", "int8_conv", "nms")
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
# phase 8: data parallel. Frames per rank and ranks of the gloo pair that
# shares the card, the SGD learning rate of the compared step, the synced
# steps timed after it, and the bound on every child process and collective
DDP_PER_RANK, DDP_RANKS, DDP_LR, DDP_TIMED_STEPS = 2, 2, 1e-2, 2
DDP_TIMEOUT_S = 600
# f32 (TF32 off): the loss and the running BN statistics (relative to each
# leaf's largest |.|) at the CPU test's bounds (tests/test_torch_port_ddp.py).
# The parameters' step is held to the noise floor of the 1-process step
# itself: at 608 with seed-0 weights, the same step on its input scaled by
# 1 +- 1e-7 or 1 + 1e-6 (DDP_PROBES) moves the step by about 5% in relative
# L2 and the parameters by up to about 0.3 (phase 8 (a) prints it; on an
# NVIDIA H100 80GB HBM3 at 700 W: 0.0484 and 0.33), while the loss and the
# statistics agree to 1e-5. The gradient is discontinuous in the forward's
# rounding: a leaky-ReLU input that changes sign, or a maxpool argmax that
# moves, sends a cell's gradient another way, and with a few targets a
# batch the gradient of a leaf gathers at a few cells. So the CPU test's
# 5e-4 on the parameters cannot hold here for any two correct
# implementations. A data-parallel step must lie within DDP_FLOOR_MARGIN
# times the largest distance of the probes (L2 of the step and max |param
# diff|), measured in the same run. Planted faults (ddp_fault_probe.py, on
# an NVIDIA H100 80GB HBM3 at 700 W, against a bound of 0.097 and 0.66) read
# step L2 1.4 with BN on the rank's own batch, 0.34 (params 4.2) without
# BN's backward all-reduce, 0.50 with an unscaled loss and 1.0 with
# per-rank loss counts; the step also moves only 0.05 for an input scaled
# by 1 + 1e-3 or 1 + 1e-2, so the floor is not a bf16-sized tolerance.
DDP_LOSS_REL, DDP_BN_REL = 1e-4, 1e-4
DDP_PROBES, DDP_FLOOR_MARGIN = (1 + 1e-7, 1 - 1e-7, 1 + 1e-6), 2.0
# bf16: the loss within 1e-2 relative and the running statistics (relative
# L2 over all leaves) no further from the 1-process bf16 step's than those
# lie from the 1-process f32 step's. The bf16 step itself is rounding noise
# at 608 (phase 8 (b) prints it; on an NVIDIA H100 80GB HBM3 at 700 W it
# lay 1.41 in relative L2 from the 1-process bf16 step and 1.41 from f32:
# uncorrelated, of equal size; the bf16 step on its input scaled by 1.01
# moves 1.37, where f32 moves 0.056), so it is held by its size only: its
# L2 norm within a factor DDP_BF16_NORM of the 1-process bf16 step's (an
# unscaled loss halves it, per-rank normalisers double it). A BN backward
# without its all-reduce passes these bf16 checks (ddp_fault_probe.py): the
# f32 check, which runs the same `bn_train`, is the one that sees it.
DDP_BF16_LOSS_REL, DDP_BF16_NORM = 1e-2, 1.5
# phase 8 (d): train frames of the two-process cli.train (2 micro-batches of
# 2 per rank, one optimizer step); the lead validates phase 6's 24 val frames
DDP_CLI_FRAMES = 8
# phase 9: the exported artifacts (name, `export_pt2` arguments, FUSED_STAGE),
# each exported for batch BATCH at 608 with phase 4's thresholds, and the
# exporter's jobs (one process each: an artifact, or the weight formats); the kernel
# launches per call; the bound on the exporter and server processes; the
# detections' distance to the eager path's (px) and the anchors' and avg
# IoU's distance between find_anchors on the card and on the CPU
EXPORT_ARTIFACTS = (("image", {"input_kind": "image"}, False),
                    ("points", {"input_kind": "points", "max_points": 20480}, False),
                    ("points_fused", {"input_kind": "points", "max_points": 20480}, True))
EXPORT_JOBS = tuple(name for name, _, _ in EXPORT_ARTIFACTS) + ("formats",)
# (the exported programs keep the plain NMS: no NMS launch)
LAUNCHES_FUSED = {"stem_conv3x3": 1, "conv3x3_fused": 2, "fused_stage": 2, "int8_conv": 0,
                  "nms": 0}
EXPORT_TIMEOUT_S = 600
EXPORT_BOX_TOL = 1e-3
ANCHOR_TOL = 1e-4
# phase 3's NMS row: the served shape (frames, complex_yolov4's decoded
# boxes at 608, k), its thresholds, and the kernel's launches a call
NMS_BATCH, NMS_ROWS, NMS_K, NMS_CONF, NMS_IOU = 16, 22743, 64, 0.5, 0.5
NMS_LAUNCHES = LAUNCHES_PATH1["nms"]
NMS_ROW = "nms"
SOURCES = {"stem_conv3x3": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           "conv3x3_fused": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           F32_ROW: "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           INT8_F32_ROW: "complex_yolov4_tpu_torch/csrc/int8_conv.cu",
           "fused_stage": "complex_yolov4_tpu_torch/csrc/fused_stage.cu",
           "int8_conv": "complex_yolov4_tpu_torch/csrc/int8_conv.cu",
           NMS_ROW: "complex_yolov4_tpu_torch/csrc/nms.cu"}
REPLACES = {"stem_conv3x3": "complex_yolov4_tpu/ops/stem_conv.py:112",
            "conv3x3_fused": "complex_yolov4_tpu/ops/pallas_conv.py:92",
            F32_ROW: "complex_yolov4_tpu/ops/pallas_conv.py:92",
            INT8_F32_ROW: "complex_yolov4_tpu/models/network.py:456",
            "fused_stage": "complex_yolov4_tpu/ops/fused_stage.py:495",
            "int8_conv": "complex_yolov4_tpu/models/network.py:456",
            NMS_ROW: "none: complex_yolov4_tpu/ops/nms.py nms_batch is XLA"}


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
        if line.startswith("== ") or "ptxas info" in line or "spill" in line:
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
              f"bound_ms={bnd:.4f} ({by}: {moved / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
              f"the kernel at {bnd / k_ms:.1%} of it, {moved / k_ms / 1e9:.3f} TB/s) "
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
    for key, r in records.items():
        print(f"[kernels] {key} main-path layers: kernel_ms={r['ms']:.4f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%} of the bound) "
              f"library_ms={r['library_ms']:.4f} plain_ms={r['plain_ms']:.4f}")
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


def phase_nms(dev):
    """The NMS kernel vs its plain version at the served shape; bound: one
    read of the decoded heads and one write of the rows and mask at the HBM
    rate (the IoU's operations are not tensor-core work and are few)."""
    from complex_yolov4_tpu_torch.ops import nms as nms_mod
    from tests._torch_port_util import nms_heads, nms_near_threshold

    rec = new_record()
    rec["library_ms"] = None
    d = nms_heads(SEED, NMS_BATCH, NMS_ROWS).to(dev)
    n0 = nms_mod.nms_batch.launches
    got_rows, got_mask = nms_mod.nms_batch(d, NMS_CONF, NMS_IOU, NMS_K)
    torch.cuda.synchronize()
    per_call = nms_mod.nms_batch.launches - n0
    want_rows, want_mask = nms_mod.nms_batch_plain(d, NMS_CONF, NMS_IOU, NMS_K)
    torch.cuda.synchronize()
    near = nms_near_threshold(d, NMS_CONF, NMS_IOU, NMS_K)
    held = [f for f in range(NMS_BATCH)
            if not (near[f] and not torch.equal(got_mask[f], want_mask[f]))]
    masks_ok = all(torch.equal(got_mask[f], want_mask[f]) for f in held)
    rel = max(float(((got_rows[f] - want_rows[f]).abs()
                     / want_rows[f].abs().clamp(min=1e-1)).max()) for f in held)
    rec["max_abs_err"] = max(float((got_rows[f] - want_rows[f]).abs().max()) for f in held)
    ok = (masks_ok and rel <= 1e-5 and per_call == NMS_LAUNCHES
          and len(held) >= NMS_BATCH - 1 and bool(torch.isfinite(got_rows).all()))
    k_ms, p_ms = timed_pair(lambda: nms_mod.nms_batch(d, NMS_CONF, NMS_IOU, NMS_K),
                            lambda: nms_mod.nms_batch_plain(d, NMS_CONF, NMS_IOU, NMS_K), 20)
    dev_ms = device_ms(lambda: nms_mod.nms_batch(d, NMS_CONF, NMS_IOU, NMS_K))
    rec["ms"], rec["plain_ms"], rec["device_ms"] = k_ms, p_ms, dev_ms
    moved = d.numel() * 4 + NMS_BATCH * NMS_K * 10 * 4
    bnd, by = add_bound(rec, moved, 0.0, "bf16")
    kept = want_mask.sum(1).int().tolist()
    print(f"[kernels] nms x{tuple(d.shape)} k={NMS_K} conf {NMS_CONF} nms {NMS_IOU}: kept per "
          f"frame {kept}; frames held to the plain keep mask {len(held)}/{NMS_BATCH} (the rest "
          f"hold a pair within 1e-5 of the threshold); masks equal {masks_ok}; rows max rel "
          f"err {rel:.3g} (tol 1e-5); launches a call {per_call} (want {NMS_LAUNCHES}); "
          f"kernel_ms={k_ms:.4f} eager, {dev_ms:.4f} device; bound_ms={bnd:.4f} ({by}: "
          f"{moved / 1e6:.1f} MB); plain_ms={p_ms:.4f} {'ok' if ok else 'FAIL'}")
    print("[kernels] nms library_ms: null, PyTorch has no rotated NMS")
    if not ok:
        raise AssertionError("NMS kernel vs plain: keep masks, rows or launches differ")
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
    returned second, times the int8 conv as f32 compute runs it: an f32
    input on the non-chained convs (which the kernel quantizes; its int32
    sums and f32 output checked here too), int8 from the chained producers,
    the chained convs writing int8 for their consumer, the others f32;
    beside the parent's route on the same inputs (`quantize_input` as eager
    ops, then the kernel from its int8 x) and over the 1x1 layers beside
    `torch._int_mm`."""
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    shapes, chained = int8_shapes(), int8_chained_out()
    assert sum(shapes.values()) == 68, shapes
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)  # activations, drawn on the card
    rec = new_record()
    rec.update(library_ms=None, library_layers=0, ms_on_library_layers=0.0, device_ms=0.0,
               library_device_ms=0.0, device_ms_on_library_layers=0.0)
    rec_f32 = new_record()
    rec_f32.update(library_ms=None, device_ms=0.0, library_layers=0, ms_on_library_layers=0.0,
                   device_ms_on_library_layers=0.0, route_ms=0.0, parent_ms=0.0,
                   parent_device_ms=0.0)
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
        # f32 compute: an f32 x where path 2 has a bf16 one (the non-chained
        # convs), which the kernel quantizes; out="int8" on the chained
        # convs, "f32" on the rest
        xf = x8 if src == "int8" else torch.randn(shape, generator=gen, device=dev)
        if src != "int8":
            p32f = i8.int8_conv_plain(xf, w, scale, b, out="int32", **kw)
            g32f = i8.int8_conv(xf, w, scale, b, out="int32", **kw)
            gff = i8.int8_conv(xf, w, scale, b, out="f32", **kw)
            torch.cuda.synchronize()
            pff = i8.epilogue(p32f, scale, b, s_x=kw["s_x"], activation="mish", out="f32")
            eq32 = eq32 and torch.equal(g32f, p32f)
            f32_rel = max(f32_rel, float((gff - pff).abs().max() / pff.abs().max()))
            rec_f32["max_abs_err"] = max(rec_f32["max_abs_err"], float((gff - pff).abs().max()))
            del p32f, g32f, gff, pff
        f_text = []
        for n, out_kw in ((count - chained[key], {"out": "f32"}),
                          (chained[key], {"out": "int8", "inv_s_next": inv_next})):
            if n == 0:
                continue
            route = functools.partial(i8.int8_conv, xf, w, scale, b, **out_kw, **kw)
            f_ms, fp_ms = timed_pair(route,
                                     lambda: i8.int8_conv_plain(xf, w, scale, b, **out_kw, **kw),
                                     5)
            f_dev = device_ms(route)
            moved_f, ops_f = conv_work(BATCH, hw, hw, c_in, c_out, k, stride, xf.element_size(),
                                       4 if out_kw["out"] == "f32" else 1, 1)
            add_bound(rec_f32, moved_f + 4 * c_out, ops_f, "int8", n)
            rec_f32["ms"] += f_ms * n
            rec_f32["plain_ms"] += fp_ms * n
            rec_f32["device_ms"] += f_dev * n
            text = f"{xf.dtype} in, {out_kw['out']} out x{n} {f_ms:.4f}, device {f_dev:.4f}"
            if src == "int8":  # the same call on either route
                r_ms, o_ms, o_dev = f_ms, f_ms, f_dev
            else:  # the parent's route: the plain quantize pass, then the kernel from int8
                def parent():
                    return i8.int8_conv(i8.quantize_input(xf, inv_s_x), w, scale, b, **out_kw,
                                        **kw)
                r_ms, o_ms = timed_pair(route, parent, 5)
                o_dev = device_ms(parent)
                text += f" (quantize_input + kernel {o_ms:.4f}, device {o_dev:.4f})"
            rec_f32["route_ms"] += r_ms * n
            rec_f32["parent_ms"] += o_ms * n
            rec_f32["parent_device_ms"] += o_dev * n
            if k == 1 and stride == 1:
                rec_f32["library_layers"] += n
                rec_f32["ms_on_library_layers"] += f_ms * n
                rec_f32["device_ms_on_library_layers"] += f_dev * n
            f_text.append(text)
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
              f"kernel_ms={k_ms:.4f} (device {dev_ms:.4f}; f32 compute: "
              f"{'; '.join(f_text)}) library_ms={lib} "
              f"bound_ms={bnd:.4f} ({by}) TOP/s={ops / dev_ms / 1e9:.1f} plain_ms={p_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((k, stride, c_in, c_out, hw, src))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        rec["ms"] += k_ms * count
        rec["plain_ms"] += p_ms * count
        del x, x8, xf, w, g32, gbf, gi8, gf32, p32, pbf, pi8, pf32
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
    # the library call computes the same int32 sums whatever the input and
    # output dtypes
    rec_f32["library_ms"] = rec["library_ms"]
    assert rec_f32["library_layers"] == rec["library_layers"]
    n_f32_in = sum(n for key, n in shapes.items() if key[-1] != "int8")
    print(f"[kernels] int8_conv in f32 compute, 68 layers ({n_f32_in} "
          f"from f32 inputs quantized in the kernel, the others int8 from "
          f"their chained producer; {sum(chained.values())} chained convs writing int8, the "
          f"others f32): {rec_f32['ms']:.4f} ms per request, device time "
          f"{rec_f32['device_ms']:.4f} ms, bound {rec_f32['bound_ms']:.4f} ms; the parent's "
          f"route (quantize_input as eager ops, then the kernel from int8) on the same inputs, "
          f"timed in turns with this one: {rec_f32['parent_ms']:.4f} against "
          f"{rec_f32['route_ms']:.4f} ms eager, device {rec_f32['parent_device_ms']:.4f} "
          f"against {rec_f32['device_ms']:.4f} ms; on its {rec_f32['library_layers']} "
          f"1x1 layers {rec_f32['ms_on_library_layers']:.4f} ms eager, device "
          f"{rec_f32['device_ms_on_library_layers']:.4f}, against torch._int_mm's "
          f"{rec['library_ms']:.4f} (device {rec['library_device_ms']:.4f}); the bf16 row's "
          f"device time {rec['device_ms']:.4f} ms")
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
    from complex_yolov4_tpu_torch.ops import conv3x3, fused_stage, int8_conv, nms, stem_conv

    return {"stem_conv3x3": stem_conv.conv3x3_stem, "conv3x3_fused": conv3x3.conv3x3_fused,
            "fused_stage": fused_stage.apply_segment, "int8_conv": int8_conv.int8_conv,
            "nms": nms.nms_batch}


def calib_rasters(dev):
    """The 2 synthetic frames (seeds 100, 101) path 2 calibrates on, (2, 608,
    608, 3) f32 numpy."""
    from complex_yolov4_tpu_torch.data import bev, synthetic

    clouds = [bev.remove_points_outside(synthetic.sample_scene(
        np.random.default_rng(100 + i))[0]) for i in range(2)]
    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
    req = bev.pack_cells_flat(list(cells_l), list(keys_l), sum(len(c) for c in cells_l))
    return raster(req, dev, 2).cpu().numpy()


def build_models(dev, sighted: bool = False):
    """(spec, folded state, path-1 model, path-2 model): complex_yolov4 @608
    bf16 from seed-0 weights (sighted: rescaled by
    `sighted.sighted_params_np` on the first calibration frame); path 2
    quantized by `default_skip` after calibration on 2 synthetic frames (as
    bench.py does), with both fused CSP stages."""
    from complex_yolov4_tpu_torch.models import quantize as qz
    from complex_yolov4_tpu_torch.models import sighted as sighted_mod
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.models.network import Darknet

    spec = zoo.get_model_spec(MODEL)
    params, state = weights.init_params_np(spec, SEED)
    calib = calib_rasters(dev)
    if sighted:
        params, state = sighted_mod.sighted_params_np(spec, params, state, calib[:1],
                                                      device=dev)
    folded = weights.fold_batchnorm(spec, params, state)
    st = weights.from_folded(spec, folded)
    path1 = Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    tree = qz.quantize_model(spec, folded, [calib], device=dev)
    print(f"[slice] int8 PTQ{' (sighted weights)' if sighted else ''}: {len(tree)} convs "
          f"calibrated on 2 frames in {time.perf_counter() - t0:.1f} s")
    path2 = Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev,
                    quant=weights.from_jax_quant(spec, tree), fused_stages=True)
    return spec, st, path1, path2


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
    rel, prob, _ = heads_err(got, ref)
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
    per routed stem, 3x3 and int8 layer, one per fused segment and the
    NMS's, and per int8 calibration batch those of the network (no int8, no
    fused segments, no NMS) that calibrates in the model's compute dtype:
    in bf16 the stem and the 3x3 kernel, in f32 the 3x3 kernel."""
    from complex_yolov4_tpu_torch.models.network import kernel_routes

    def count(routes, nms):
        n = dict.fromkeys(KERNEL_NAMES, 0)
        n["nms"] = nms
        for r in routes.values():
            if r in ("stem", "conv3x3", "int8"):
                n[{"stem": "stem_conv3x3", "conv3x3": "conv3x3_fused",
                   "int8": "int8_conv"}[r]] += 1
        n["fused_stage"] = len({r for r in routes.values() if r.startswith("fused_stage")})
        return n

    per_batch = count(model.routes(608), NMS_LAUNCHES)
    calib = count(kernel_routes(model.spec, 608, model.compute_dtype), 0)
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
    rel, prob, _ = heads_err(got, ref)
    print(f"[eval] {label} decoded {tuple(got.shape)} kernel vs plain path: max rel err per "
          f"column={rel:.3g} (tol {rel_tol}), max abs err conf/cls={prob:.3g} "
          f"(tol {prob_tol})")
    if rel > rel_tol or prob > prob_tol:
        raise AssertionError(f"{label}: kernel path and plain path disagree")


def heads_err(got, ref):
    """Two decoded (B, N, 10) heads: (max |diff| per column relative to the
    column's scale, max |diff| on conf/cls, the per-column relative list)."""
    diff = (got.float() - ref.float()).abs().amax(dim=(0, 1))
    cols = diff / (ref.float().abs().amax(dim=(0, 1)) + 1e-6)
    return float(cols.max()), float(diff[6:].max()), cols.tolist()


@contextlib.contextmanager
def zeroed(model, layer: int):
    """A planted fault: conv `layer`'s weights zeroed in every buffer a
    route reads (`w`, the packed `wk`, the int8 `wq`), the fused segments
    rebuilt from them; restored after."""
    saved = {}
    for name in (f"w{layer}", f"wk{layer}", f"wq{layer}"):
        if hasattr(model, name):
            saved[name] = getattr(model, name).clone()
            getattr(model, name).zero_()
    model._segments.clear()
    try:
        yield
    finally:
        for name, buf in saved.items():
            getattr(model, name).copy_(buf)
        model._segments.clear()


def conv3x3_cudnn(x, w_packed, bias, *, stride: int, activation: str):
    """The 3x3 kernel's function through cuDNN: the bf16-rounded operands
    convolved in f32 (TF32 off), then the f32 bias and the activation, out
    in x's dtype; `conv3x3_plain` summed in another order."""
    import torch.nn.functional as F

    from complex_yolov4_tpu_torch.models.network import no_tf32
    from complex_yolov4_tpu_torch.ops.activations import act

    c_in, c_out = x.shape[-1], w_packed.shape[1]
    w = w_packed.float().reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    with no_tf32():
        y = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2), w, bias.float(),
                     stride=stride, padding=1)
    return act(y.permute(0, 2, 3, 1), activation).to(x.dtype)


@contextlib.contextmanager
def cudnn_routed(model):
    """The floor of a sighted check: `model`'s all-plain path with the
    routed stem and 3x3 layers through `conv3x3_cudnn` and its fused
    segments run layer by layer by the executor (int8 convs stay plain), a
    second correct implementation of every routed layer."""
    from complex_yolov4_tpu_torch.ops import conv3x3, stem_conv

    saved = conv3x3.conv3x3_plain, stem_conv.stem_plain, model.fused_stages
    conv3x3.conv3x3_plain = conv3x3_cudnn
    stem_conv.stem_plain = lambda x, w, b, *, activation: conv3x3_cudnn(
        x, w, b, stride=1, activation=activation).to(torch.bfloat16)
    model.fused_stages = False
    try:
        yield
    finally:
        conv3x3.conv3x3_plain, stem_conv.stem_plain, model.fused_stages = saved


def rms_err(got, ref) -> float:
    """The sighted checks' statistic: on decoded (B, N, 10) heads, per
    column the RMS difference relative to the column's RMS, the largest
    column's; on a layer's activation, the same over the whole tensor."""
    d, r = (got.float() - ref.float()).square(), ref.float().square()
    dims = (0, 1) if got.dim() == 3 else tuple(range(got.dim()))
    return float((d.mean(dim=dims).sqrt() / r.mean(dim=dims).sqrt()).max())


def share_moved(got, ref) -> float:
    """The statistic of a sighted check that one-ulp flips of int8 steps
    would swamp under `rms_err`: on decoded (B, N, 10) heads, per column the
    share of elements that moved by more than half the column's RMS, the
    largest column's; on a layer's activation, the same over the whole
    tensor."""
    d, r = (got.float() - ref.float()).abs(), ref.float()
    dims = (0, 1) if got.dim() == 3 else tuple(range(got.dim()))
    half_rms = 0.5 * r.square().mean(dim=dims, keepdim=True).sqrt()
    return float((d > half_rms).float().mean(dim=dims).max())


STATISTICS = {"rms_err": rms_err, "share_moved": share_moved}


def sighted_check(label, models, blinds, img):
    """Phase 4 (s), one entry of SIGHTED_CHECKS: the kernel path of
    `models[path]` (sighted weights) against its all-plain path on `img`, at
    the heads or at one layer, with the floor (`cudnn_routed`) beside it;
    then each planted fault in the kernel path, and for a head check the
    same fault in `blinds[path]` (seed-0 weights) against that model's own
    head check (the largest per-column difference, `heads_err`)."""
    path, stop, stat, tol, faults, margin = SIGHTED_CHECKS[label]
    model, (blind, blind_tol), measure = models[path], blinds[path], STATISTICS[stat]
    with torch.inference_mode():
        ref = model(img, kernels=False, stop_after=stop)
        got = model(img, kernels=True, stop_after=stop)
        with cudnn_routed(model):
            alt = model(img, kernels=False, stop_after=stop)
        blind_ref = blind(img, kernels=False) if stop is None else None
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"sighted {label}: non-finite output")
    err, floor = measure(got, ref), measure(alt, ref)
    where = "decoded heads" if stop is None else f"layer {stop}'s output"
    largest = (f"; largest per-column difference {heads_err(got, ref)[0]:.4g} (floor "
               f"{heads_err(alt, ref)[0]:.4g})" if stop is None else "")
    print(f"[sighted] {label}: {where} {tuple(got.shape)} kernel vs plain path: {stat}="
          f"{err:.4g} (tol {tol}); floor (plain path vs the routed layers on cuDNN, fused "
          f"segments layer by layer) {floor:.4g}{largest}")
    if err > tol:
        raise AssertionError(f"sighted {label}: kernel path and plain path disagree")
    for fault in faults:
        layer = FAULT_LAYERS[fault]
        with zeroed(model, layer), torch.inference_mode():
            move = measure(model(img, kernels=True, stop_after=stop), ref) / tol
        text = (f"[sighted] {label} planted fault {fault} (layer {layer}'s weights zeroed in the "
                f"kernel path): the sighted check moves {move:.4g}x its tolerance (need >= "
                f"{margin:g})")
        if stop is None:
            with zeroed(blind, layer), torch.inference_mode():
                rel, prob, _ = heads_err(blind(img, kernels=True), blind_ref)
            text += (f", the seed-0 head check {max(rel / blind_tol[0], prob / blind_tol[1]):.4g}x "
                     f"its own")
        print(text)
        if move < margin:
            raise AssertionError(f"sighted {label}: planted fault {fault} not seen")


def f32_route(model, blind, img):
    """Phase 4 (s): the default f32 forward of `model` (sighted weights; no
    route: every conv cuDNN f32, TF32 off) against the CPU's f32 forward of
    the same model, and the 3x3 route (`conv3x3.F32_ENABLED`) against the
    default, per head column; the seed-0 `blind` model's route move
    beside it."""
    from complex_yolov4_tpu_torch.ops import conv3x3

    fns = counters()
    moves = {}
    for label, m in (("sighted", model), ("seed-0", blind)):
        n0 = fns["conv3x3_fused"].launches
        with torch.inference_mode():
            default = m(img)
            n1 = fns["conv3x3_fused"].launches
            conv3x3.F32_ENABLED = True
            try:
                routed = m(img)
            finally:
                conv3x3.F32_ENABLED = False
        torch.cuda.synchronize()
        if (n1 - n0, fns["conv3x3_fused"].launches - n1) != (0, 5):
            raise AssertionError(f"f32 route {label}: 3x3 launches {n1 - n0}, "
                                 f"{fns['conv3x3_fused'].launches - n1} != 0, 5")
        moves[label] = heads_err(routed, default)
        print(f"[sighted] f32 3x3 route (layers 1, 6, 11, 16, 19 on cyv4_conv3x3_f32) vs the "
              f"default all-cuDNN f32 forward, {label} weights: max rel err per column="
              f"{moves[label][0]:.4g}, conf/cls {moves[label][1]:.4g}; per column "
              + " ".join(f"{c:.3g}" for c in moves[label][2]))
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        default = model(img)
        on_cpu = model.replicate(cpu)(img.to(cpu))
    rel, prob, cols = heads_err(default.to(cpu), on_cpu)
    print(f"[sighted] f32 default forward on the card vs the CPU's f32 forward (all f32), "
          f"sighted weights: max rel err per column={rel:.4g}, conf/cls {prob:.4g} (tol "
          f"{F32_ROUTE_TOL}); per column " + " ".join(f"{c:.3g}" for c in cols)
          + f" ({time.perf_counter() - t0:.1f} s with the CPU forward)")
    if rel > F32_ROUTE_TOL or prob > F32_ROUTE_TOL:
        raise AssertionError("the default f32 forward is off the all-f32 forward")


def phase_sighted(dev, blind_state, path1, path2):
    """Phase 4 (s): the checks of SIGHTED_CHECKS on the first 2 frames of
    request 0 and the f32 route, on sighted weights
    (`build_models(sighted=True)`); the seed-0 `path1`, `path2` and an f32
    model of `blind_state` beside them."""
    from complex_yolov4_tpu_torch.models.network import Darknet
    from complex_yolov4_tpu_torch.ops import conv3x3

    t0 = time.perf_counter()
    spec, state, s1, s2 = build_models(dev, sighted=True)
    models = {"path 1": s1, "path 2": s2,
              "f32": Darknet(spec, state, compute_dtype=torch.float32, device=dev)}
    del state
    bf16_tol, f32_tol = (DECODED_REL_TOL, PROB_ABS_TOL), (F32_HEADS_TOL, F32_HEADS_TOL)
    blinds = {"path 1": (path1, bf16_tol), "path 2": (path2, bf16_tol),
              "f32": (Darknet(spec, blind_state, compute_dtype=torch.float32, device=dev),
                      f32_tol)}
    img = raster(host_coo(make_scenes(0)), dev, BATCH)[:2].permute(0, 3, 1, 2)
    print(f"[sighted] models built in {time.perf_counter() - t0:.1f} s")
    for label, (path, *_) in SIGHTED_CHECKS.items():
        conv3x3.F32_ENABLED = path == "f32"
        try:
            sighted_check(label, models, blinds, img)
        finally:
            conv3x3.F32_ENABLED = False
    f32_route(models["f32"], blinds["f32"][0], img)


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
    want["nms"] = NMS_LAUNCHES * val_batches
    n_steps = len(timings["step"])
    print(f"[train] cli.train: {MODEL} @608 bf16 batch {TRAIN_BATCH}, subdivisions "
          f"{TRAIN_SUBDIV}: {n_steps} micro-batches, {state.global_step // TRAIN_SUBDIV} "
          f"optimizer steps, step ms (host, first pays first-use costs) "
          + " ".join(f"{x * 1e3:.1f}" for x in timings["step"])
          + f"; f32 validation mAP={timings['mAP'][0]:.4f} in {timings['val'][0]:.2f} s; "
          f"whole run {wall:.1f} s; launches {got} (validation: {per_val_batch} f32 3x3 "
          f"launches and {NMS_LAUNCHES} NMS launches per batch, 3x3 from the default f32 "
          f"routes {spec_routes}, {val_batches} "
          f"batches)")
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
    if (got != want or model.compute_dtype != torch.float32
            or any(v for k, v in per_batch.items() if k != "nms")
            or n_batches != TRAIN_VAL_FRAMES // BATCH):
        raise AssertionError(f"f32 eval of the checkpoint: {got} != {want}")
    ref = state.model.to_serving(dev, torch.float32)
    for name, buf in ref.named_buffers():
        if not torch.equal(buf, getattr(model, name)):
            raise AssertionError(f"checkpoint weights differ from the trained model: {name}")
    del ref
    launches["eval f32 checkpoint"] = got

    def warm_f32(label, model):
        warm = warm_pass(model, root, eval_argv, ())
        print(f"[train] f32 eval warm pass{label}: device_ms/batch "
              + " ".join(f"{x * 1e3:.2f}" for x in warm["infer"])
              + " match_ms/batch " + " ".join(f"{x * 1e3:.2f}" for x in warm["match"])
              + " wait_ms/batch " + " ".join(f"{x * 1e3:.2f}" for x in warm["load"])
              + f"; eval frames/s over batches 2-{len(warm['infer'])} "
              f"({TRAIN_VAL_FRAMES - BATCH} frames, the first batch left out)="
              f"{warm_rate(warm, BATCH):.2f}")

    warm_f32("", model)
    del model
    lap("f32 eval of the checkpoint")

    # the same with the f32 3x3 route switched on (the reference's
    # `pallas_conv.ENABLED`): the f32 kernel's launches, the heads against
    # the all-plain path, and the mAP and frames/s beside the default's
    from complex_yolov4_tpu_torch.ops import conv3x3

    for fn in fns.values():
        fn.launches = 0
    conv3x3.F32_ENABLED = True
    try:
        routed = {}
        out_r, model = evaluate.main(eval_argv, timings=routed)
        got = {k: fn.launches for k, fn in fns.items()}
        per_batch, want = expected_launches(model, len(routed["infer"]), 0)
        print(f"[train] checkpoint in cli.evaluate, f32 with the 3x3 route "
              f"(conv3x3.F32_ENABLED): mAP={float(out_r['mAP']):.4f} (default "
              f"{float(out['mAP']):.4f}, difference {float(out_r['mAP']) - float(out['mAP']):.4g}) "
              f"launches {got}, per batch from model.routes(608) {per_batch}")
        if got != want or per_batch["conv3x3_fused"] != 5 or per_batch["stem_conv3x3"]:
            raise AssertionError(f"f32 eval with the 3x3 route: {got} != {want}")
        launches["eval f32 checkpoint, 3x3 route on"] = got
        first, _ = eval_loader(root, ())
        check_heads("f32 checkpoint (3x3 route on)", model, next(iter(first)), dev,
                    rel_tol=F32_HEADS_TOL, prob_tol=F32_HEADS_TOL)
        warm_f32(" (3x3 route on)", model)
    finally:
        conv3x3.F32_ENABLED = False
    del model
    lap("f32 eval of the checkpoint with the 3x3 route")

    # the checkpoint served int8 in f32 compute (calibrated in f32, the
    # int8 convs writing f32); the kernel quantizes each f32 input, so the
    # plain `quantize_input` pass must not run on the card
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    for fn in fns.values():
        fn.launches = 0
    cold_i8 = {}
    quantize_calls = []
    real_quantize = i8.quantize_input
    i8.quantize_input = lambda *a, **k: quantize_calls.append(1) or real_quantize(*a, **k)
    try:
        out_i8, model_i8 = evaluate.main(eval_argv + ["--quantize", "int8", "--calib_batches",
                                                      "1", "--num_samples", str(BATCH)],
                                         timings=cold_i8)
    finally:
        i8.quantize_input = real_quantize
    got = {k: fn.launches for k, fn in fns.items()}
    per_batch, want = expected_launches(model_i8, len(cold_i8["infer"]), 1)
    print(f"[train] checkpoint in cli.evaluate --quantize int8 (f32 compute, the first "
          f"{BATCH} frames): "
          f"mAP={float(out_i8['mAP']):.4f} launches {got}, per batch from "
          f"model.routes(608) {per_batch} plus the f32 calibration batch; device_ms/batch "
          + " ".join(f"{x * 1e3:.2f}" for x in cold_i8["infer"])
          + f"; eval frames/s (cold, every batch)="
          f"{BATCH / cold_i8['total'][0]:.2f}; quantize_input calls {len(quantize_calls)}")
    if (got != want or per_batch["int8_conv"] != 68 or quantize_calls
            or {kw.get("out") for kw in model_i8._int8_kw.values()} != {"f32", "int8"}):
        raise AssertionError(f"int8 f32 eval of the checkpoint: {got} != {want} or "
                             f"{len(quantize_calls)} quantize_input calls")
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
    launches and the NMS's. Returns the launches."""
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


def ddp_global_batch():
    """Phase 8's global batch: DDP_RANKS * DDP_PER_RANK uniform 608 rasters
    with 3 targets each, from a numpy seed; rank r's shard is frames
    [r * DDP_PER_RANK, (r + 1) * DDP_PER_RANK)."""
    rng = np.random.default_rng(SEED + 8)
    b = DDP_RANKS * DDP_PER_RANK
    batch = {"image": rng.uniform(size=(b, 608, 608, 3)).astype(np.float32),
             "targets": np.zeros((b, 50, 7), np.float32),
             "target_mask": np.zeros((b, 50), np.float32)}
    for f in range(b):
        for t in range(3):
            yaw = rng.uniform(-np.pi, np.pi)
            batch["targets"][f, t] = [t, rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9),
                                      rng.uniform(0.02, 0.1), rng.uniform(0.05, 0.2),
                                      np.sin(yaw), np.cos(yaw)]
            batch["target_mask"][f, t] = 1
    return batch


def ddp_shard(batch, rank):
    return {k: v[rank * DDP_PER_RANK:(rank + 1) * DDP_PER_RANK] for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ddp_init(dev):
    """The seed-0 complex_yolov4 train state dict on `dev`, built once on the
    host (its numpy init and conversion take about a second) and copied."""
    from complex_yolov4_tpu_torch.models import weights, zoo

    if dev.type != "cpu":
        return {k: v.to(dev) for k, v in ddp_init(torch.device("cpu")).items()}
    spec = zoo.get_model_spec(MODEL)
    params, bn_state = weights.init_params_np(spec, SEED)
    return weights.to_train_state(spec, params, bn_state)


def ddp_state(dtype, dev):
    """A fresh complex_yolov4 train state from the seed-0 weights, SGD (the
    weights copied from the host, so that the card holds no cached copy)."""
    from complex_yolov4_tpu_torch import train as T
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.network import TrainDarknet

    model = TrainDarknet(zoo.get_model_spec(MODEL), compute_dtype=dtype).to(dev)
    model.load_state_dict(ddp_init(torch.device("cpu")))
    return T.TrainState(model, T.create_optimizer(model, optimizer_type="sgd"))


def step_distance(got, ref, init):
    """got/ref/init: state dicts on the card. -> {param_abs: max |got - ref|
    over the parameters, step_rel: the largest per-leaf max |step - ref
    step| / max |ref step|, bn_rel: the largest per-leaf max |diff| / max
    |ref| of the running statistics, step_l2 / bn_l2: the same as relative
    L2 distances over all leaves, norm_ratio: |step| / |ref step| in L2}."""
    out = {"param_abs": 0.0, "step_rel": 0.0, "bn_rel": 0.0}
    sq = {"step": [0.0, 0.0], "bn": [0.0, 0.0]}
    norm2 = 0.0
    for k, r in ref.items():
        g = got[k].to(r.device, torch.float32)
        r = r.float()
        if k.endswith((".mean", ".var")):
            out["bn_rel"] = max(out["bn_rel"], float((g - r).abs().max()
                                                     / r.abs().max().clamp(min=1e-12)))
            sq["bn"][0] += float(((g - r) ** 2).sum())
            sq["bn"][1] += float((r ** 2).sum())
            continue
        d_ref, d = r - init[k].float(), g - init[k].float()
        out["param_abs"] = max(out["param_abs"], float((g - r).abs().max()))
        out["step_rel"] = max(out["step_rel"], float((d - d_ref).abs().max()
                                                     / d_ref.abs().max().clamp(min=1e-12)))
        sq["step"][0] += float(((d - d_ref) ** 2).sum())
        sq["step"][1] += float((d_ref ** 2).sum())
        norm2 += float((d ** 2).sum())
    for name, (num, den) in sq.items():
        out[f"{name}_l2"] = (num / max(den, 1e-30)) ** 0.5
    out["norm_ratio"] = (norm2 / max(sq["step"][1], 1e-30)) ** 0.5
    return out


def plain_step(batch, dtype, dev, scale=1.0):
    """(loss, state dict on the card) of one SGD step of a fresh state on
    `batch`, its images scaled by `scale`."""
    from complex_yolov4_tpu_torch import train as T

    state = ddp_state(dtype, dev)
    b = dict(batch, image=(batch["image"] * np.float32(scale)).astype(np.float32))
    loss = float(T.make_train_step()(state, b, DDP_LR)["loss"])
    return loss, state.model.state_dict()


def ddp_f32_ok(label, loss, sd, ref, floor, init):
    """Print and judge an f32 data-parallel step (loss, state dict) against
    the 1-process reference `ref` (loss, state dict) and its noise floor."""
    d = step_distance(sd, ref[1], init)
    loss_rel = abs(loss - ref[0]) / abs(ref[0])
    ok = (loss_rel <= DDP_LOSS_REL and d["bn_rel"] <= DDP_BN_REL
          and d["step_l2"] <= DDP_FLOOR_MARGIN * floor["step_l2"]
          and d["param_abs"] <= DDP_FLOOR_MARGIN * floor["param_abs"])
    print(f"[ddp] {label}: loss {loss:.7g} vs {ref[0]:.7g} (rel {loss_rel:.3g}, tol "
          f"{DDP_LOSS_REL}); BN statistics max rel {d['bn_rel']:.3g} (tol {DDP_BN_REL}); step "
          f"relative L2 {d['step_l2']:.3g}, params max abs diff {d['param_abs']:.3g} (tol "
          f"{DDP_FLOOR_MARGIN:g} x the floor {floor['step_l2']:.3g}, {floor['param_abs']:.3g}); "
          f"step max rel per leaf {d['step_rel']:.3g} (floor {floor['step_rel']:.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def ddp_bf16_ok(label, loss, sd, ref16, ref32, init):
    """Print and judge a bf16 data-parallel step (loss, state dict) against
    the 1-process bf16 step `ref16`, with the 1-process f32 step `ref32` as
    the yardstick of the BN statistics (DDP_BF16_LOSS_REL, DDP_BF16_NORM)."""
    bf = step_distance(sd, ref16[1], init)
    yard = step_distance(ref16[1], ref32[1], init)
    loss_rel = abs(loss - ref16[0]) / abs(ref16[0])
    ok = (loss_rel <= DDP_BF16_LOSS_REL and bf["bn_l2"] <= yard["bn_l2"]
          and 1 / DDP_BF16_NORM <= bf["norm_ratio"] <= DDP_BF16_NORM)
    print(f"[ddp] {label}: loss {loss:.7g} vs {ref16[0]:.7g} (rel {loss_rel:.3g}, tol "
          f"{DDP_BF16_LOSS_REL}); BN statistics relative L2 {bf['bn_l2']:.3g} (bound: 1-process "
          f"bf16 vs f32 {yard['bn_l2']:.3g}); step norm / 1-process bf16 step norm "
          f"{bf['norm_ratio']:.4g} (within {DDP_BF16_NORM:g}x; 1-process bf16 / f32 "
          f"{yard['norm_ratio']:.4g}); relative L2 of the step {bf['step_l2']:.3g} (1-process "
          f"bf16 vs f32 {yard['step_l2']:.3g}), max abs param diff {bf['param_abs']:.3g}, BN max "
          f"rel {bf['bn_rel']:.3g} {'ok' if ok else 'FAIL'}")
    return ok


def phase_ddp_nccl(dev):
    """Phase 8 (a): an NCCL group of one rank on the card; complex_yolov4 @608
    f32 (TF32 off) on phase 8's global batch: the step under
    `parallel.wrap_ddp` (BN and the loss's counts all-reduced over the
    group, DDP's gradient all-reduce) against the plain step, from the same
    state, and the plain step's noise floor (the largest distance of its
    DDP_PROBES). Returns (reference, floor, initial state dict) for (b)."""
    import datetime
    import socket

    import torch.distributed as dist

    from complex_yolov4_tpu_torch import parallel
    from complex_yolov4_tpu_torch import train as T

    batch = ddp_global_batch()
    init = ddp_init(dev)
    ref = plain_step(batch, torch.float32, dev)
    probes = [step_distance(plain_step(batch, torch.float32, dev, x)[1], ref[1], init)
              for x in DDP_PROBES]
    floor = {k: max(p[k] for p in probes) for k in probes[0]}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S),
                            device_id=dev)
    try:
        wrapped = ddp_state(torch.float32, dev)
        wrapped.ddp = parallel.wrap_ddp(wrapped.model, dev)
        loss = float(T.make_train_step()(wrapped, batch, DDP_LR)["loss"])
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    ok = ddp_f32_ok(f"(a) {backend} group of 1 rank, {MODEL} @608 f32 (TF32 off) batch "
                    f"{DDP_RANKS * DDP_PER_RANK}, the DDP step vs the plain step", loss,
                    wrapped.model.state_dict(), ref, floor, init)
    if not ok or backend != "nccl":
        raise AssertionError("phase 8 (a): the NCCL-wrapped step differs from the plain step")
    del wrapped
    torch.cuda.empty_cache()
    return ref, floor, init


def _wait_for_file(path: str, timeout_s: float) -> str:
    """The contents of `path` once it exists (polled), within `timeout_s`."""
    import os

    deadline = time.perf_counter() + timeout_s
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)
    with open(path) as f:
        return f.read()


def _signal(path: str, text: str = "") -> None:
    """Write `text` to `path` whole (a rename), for `_wait_for_file`."""
    import os

    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def ddp_rank(argv):
    """One rank of phase 8's gloo pair, in a process of its own:
    ``chip_smoke.py --ddp-rank RANK PORT OUT_DIR WORK_DIR``. It starts while
    nvcc builds (phase 2), at the lowest CPU priority: it joins the gloo
    group, builds the weights on the host and imports what the first
    optimizer needs, then waits for
    OUT_DIR/go (written at phase 8, after the phases that time the host;
    it holds TRAIN_ROOT). (b) per dtype (f32, then bf16) a fresh
    complex_yolov4 @608 under `parallel.wrap_ddp` takes the compared step on
    its shard of `ddp_global_batch` (rank 0 saves its state and loss to
    OUT_DIR), then DDP_TIMED_STEPS synced steps; each step's ms and the peak
    memory are printed; rank 0 then writes OUT_DIR/b.done. (d)
    `cli.train.main --num_processes 2` on DDP_CLI_FRAMES frames of
    TRAIN_ROOT, in the same gloo group, with the lead's f32 validation; its
    launch counts are printed. Every printed record is one JSON line after
    "[ddp-rank] "."""
    import os

    from complex_yolov4_tpu_torch import parallel
    from complex_yolov4_tpu_torch import train as T
    from complex_yolov4_tpu_torch.cli import train

    t_start = time.perf_counter()
    rank, port, out_dir, wd = int(argv[0]), argv[1], argv[2], argv[3]
    # the lowest CPU priority: the set-up below yields the host's cores to
    # nvcc and to the phases that time the host; at phase 8 the main
    # process only waits while (b) runs
    os.nice(19)
    # the first optimizer imports torch._dynamo (seconds of host time): import
    # it while the group forms and the weights are built
    dynamo = threading.Thread(target=importlib.import_module, args=("torch._dynamo",),
                              daemon=True)
    dynamo.start()
    dev = torch.device("cuda", 0)
    parallel.initialize_distributed(f"localhost:{port}", DDP_RANKS, rank, device=dev,
                                    backend="gloo", timeout_s=DDP_TIMEOUT_S)
    try:
        shard = ddp_shard(ddp_global_batch(), rank)
        ddp_init(torch.device("cpu"))
        dynamo.join()
        t_ready = time.perf_counter() - t_start
        train_root = _wait_for_file(os.path.join(out_dir, "go"), DDP_TIMEOUT_S)
        t_go = time.perf_counter()
        for dtype in (torch.float32, torch.bfloat16):
            state = ddp_state(dtype, dev)
            state.ddp = parallel.wrap_ddp(state.model, dev)
            step = T.make_train_step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for i in range(1 + DDP_TIMED_STEPS):
                t0 = time.perf_counter()
                loss = float(step(state, shard, DDP_LR)["loss"])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and rank == 0:
                    torch.save({"loss": loss, "state": {k: v.cpu() for k, v in
                                                        state.model.state_dict().items()}},
                               os.path.join(out_dir, f"{str(dtype)[6:]}.pt"))
            print("[ddp-rank] " + json.dumps({
                "part": "b", "rank": rank, "dtype": str(dtype)[6:], "step_ms": ms,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                "ready_s": t_ready, "done_s": time.perf_counter() - t_go}), flush=True)
            del state, step
            torch.cuda.empty_cache()
        if rank == 0:
            _signal(os.path.join(out_dir, "b.done"))

        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        timings = {}
        state = train.main(
            ["--dataset_dir", train_root, "--model", MODEL, "--batch_size", str(DDP_PER_RANK),
             "--subdivisions", "2", "--num_epochs", "1", "--num_samples", str(DDP_CLI_FRAMES),
             "--working_dir", wd, "--print_freq", "1", "--checkpoint_freq", "1",
             "--conf_thresh", str(EVAL_CONF), "--num_processes", str(DDP_RANKS),
             "--process_id", str(rank), "--coordinator_address", f"localhost:{port}"],
            timings=timings)
        torch.cuda.synchronize()
        print("[ddp-rank] " + json.dumps({
            "part": "d", "rank": rank, "launches": {k: fn.launches for k, fn in fns.items()},
            "micro_batches": len(timings["step"]), "global_step": state.global_step,
            "step_ms": [x * 1e3 for x in timings["step"]], "loss": timings["loss"],
            "mAP": timings["mAP"], "val_s": timings["val"],
            "done_s": time.perf_counter() - t_go}), flush=True)
    finally:
        parallel.destroy()


def start_ddp_ranks(tmp):
    """Start phase 8's gloo pair (`ddp_rank`): two processes on the one card,
    each writing its output to OUT_DIR/rank<r>.log. -> (processes, OUT_DIR,
    WORK_DIR)."""
    import os
    import socket

    out_dir = os.path.join(tmp, "ddp_out")
    wd = os.path.join(tmp, "ddp_wd")
    os.makedirs(out_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r), str(port),
                 out_dir, wd], cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, out_dir, wd


def kill_ranks(procs):
    for p in procs:
        p.kill()
    for p in procs:
        p.wait()


def wait_ddp_ranks(procs, out_dir):
    """Wait for the gloo pair, each within DDP_TIMEOUT_S (both killed when it
    runs out). -> {(part, rank): record}."""
    import os

    try:
        for p in procs:
            p.wait(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        kill_ranks(procs)
        raise AssertionError(f"phase 8: the gloo ranks did not finish in {DDP_TIMEOUT_S} s")
    records = {}
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            out = f.read()
        if p.returncode != 0:
            print(out[-6000:])
            raise AssertionError(f"phase 8: gloo rank {r} exited {p.returncode}")
        for line in out.splitlines():
            if line.startswith("[ddp-rank] "):
                rec = json.loads(line[len("[ddp-rank] "):])
                records[(rec["part"] + rec.get("dtype", ""), r)] = rec
    return records


def phase_ddp_gloo(dev, ranks, train_root):
    """Phase 8: (b) and (d) in the gloo pair `ranks` (`start_ddp_ranks`,
    started in phase 2 and waiting since), (a) in this process. The pair is
    let go; while it takes (b)'s steps this process waits, so that their ms
    are the pair's own; then (a) runs here beside (d). Holds (b) rank 0's
    step against the 1-process step on the global batch (f32: (a)'s
    reference and noise floor; bf16: DDP_BF16_LOSS_REL and no further than
    bf16 from f32) and checks (d): one epoch, the lead's validation through
    the f32 3x3 kernel, no launch on rank 1 (it trains only), lead-only log
    and checkpoint. Returns the lead's launches of (d)."""
    import os

    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.network import kernel_routes

    procs, out_dir, wd = ranks
    t0 = time.perf_counter()
    _signal(os.path.join(out_dir, "go"), train_root)
    _wait_for_file(os.path.join(out_dir, "b.done"), DDP_TIMEOUT_S)
    t_b = time.perf_counter() - t0
    ref32, floor, init = phase_ddp_nccl(dev)
    ref16 = plain_step(ddp_global_batch(), torch.bfloat16, dev)
    t_a = time.perf_counter() - t0 - t_b
    records = wait_ddp_ranks(procs, out_dir)
    print(f"[ddp] phase 8 timeline, s: (b) in the gloo pair {t_b:.1f}; then (a) and the bf16 "
          f"reference here {t_a:.1f}, beside (d) in the pair; all done "
          f"{time.perf_counter() - t0:.1f}")
    for name in ("float32", "bfloat16"):
        for r in range(DDP_RANKS):
            rec = records[("b" + name, r)]
            print(f"[ddp] (b) rank {r} {name}: step ms (the compared step first, then "
                  f"{DDP_TIMED_STEPS} more, synced; gloo carries the all-reduces through the "
                  f"host, both ranks share the card) "
                  + " ".join(f"{x:.1f}" for x in rec["step_ms"])
                  + f"; peak memory {rec['peak_gib']:.2f} GiB")
    for r in range(DDP_RANKS):
        print(f"[ddp] rank {r}: group joined, weights built and the optimizer's imports done "
              f"{records[('bfloat32', r)]['ready_s']:.1f} s after its start (beside nvcc); "
              f"after the go: (b) f32 done {records[('bfloat32', r)]['done_s']:.1f} s, (b) bf16 "
              f"done {records[('bbfloat16', r)]['done_s']:.1f} s, (d) done "
              f"{records[('d', r)]['done_s']:.1f} s")
    got = {name: torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
           for name in ("float32", "bfloat16")}
    ok32 = ddp_f32_ok(f"(b) f32 (TF32 off), 2 ranks x {DDP_PER_RANK} vs 1 process x "
                      f"{DDP_RANKS * DDP_PER_RANK}", got["float32"]["loss"],
                      got["float32"]["state"], ref32, floor, init)
    ok16 = ddp_bf16_ok("(b) bf16, 2 ranks vs 1 process", got["bfloat16"]["loss"],
                       got["bfloat16"]["state"], ref16, ref32, init)
    del got, ref16, ref32, init
    ddp_init.cache_clear()
    torch.cuda.empty_cache()
    if not (ok32 and ok16):
        raise AssertionError("phase 8 (b): the two-rank step differs from the 1-process step")

    lead, other = records[("d", 0)], records[("d", 1)]
    routes = kernel_routes(zoo.get_model_spec(MODEL), 608, torch.float32)
    val_batches = -(-TRAIN_VAL_FRAMES // DDP_PER_RANK)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["conv3x3_fused"] = sum(1 for r in routes.values() if r == "conv3x3") * val_batches
    want["nms"] = NMS_LAUNCHES * val_batches
    micro = DDP_CLI_FRAMES // (DDP_RANKS * DDP_PER_RANK)
    ckpts = os.listdir(os.path.join(wd, "checkpoints", "complexer_yolo"))
    log = open(os.path.join(wd, "logs", "complexer_yolo", "logger_complexer_yolo.txt")).read()
    print(f"[ddp] (d) cli.train --num_processes 2 over gloo on the card (beside (a)), {MODEL} "
          f"@608 bf16, "
          f"batch {DDP_PER_RANK} per rank, subdivisions 2, {DDP_CLI_FRAMES} frames: "
          f"micro-batches {lead['micro_batches']} and {other['micro_batches']}, global_step "
          f"{lead['global_step']} and {other['global_step']}; step ms rank 0 "
          + " ".join(f"{x:.1f}" for x in lead["step_ms"]) + ", rank 1 "
          + " ".join(f"{x:.1f}" for x in other["step_ms"])
          + f"; losses {lead['loss']}; the lead's f32 validation mAP={lead['mAP']} in "
          f"{lead['val_s']} s; launches lead {lead['launches']}, rank 1 {other['launches']}; "
          f"checkpoints {ckpts}")
    ok = (lead["micro_batches"] == other["micro_batches"] == micro
          and lead["global_step"] == other["global_step"] == micro
          and lead["launches"] == want and not any(other["launches"].values())
          and len(lead["mAP"]) == 1 and not other["mAP"] and ckpts == ["epoch_1.ckpt"]
          and log.count("training done") == 1 and np.isfinite(lead["loss"]).all())
    if not ok:
        raise AssertionError(f"phase 8 (d): two-process cli.train off (launches want {want})")
    return lead["launches"]


def phase_ddp_serve(path1, dev):
    """Phase 8 (c): path 1 served over two replicas on the card
    (`make_inference_fn(devices=[cuda:0, cuda:0])`, batched COO cells split
    4 + 4), the launch counts set to 0 just before: each replica's stem,
    3x3 and NMS launches per request. Its detections equal, bit for bit, the
    one-device function's on each replica's share (batch 4); beside them,
    the one-device batch of 8 (cuDNN may pick another algorithm at batch 8,
    and random weights put many candidates at the threshold, so those are
    printed, not held). Returns the launches."""
    from complex_yolov4_tpu_torch.data import bev
    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn

    kw = dict(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64, from_cells=True)
    one = make_inference_fn(**kw)
    two = make_inference_fn(devices=[dev, dev], **kw)
    reqs = []
    for r in range(2):
        cells_l, keys_l = zip(*map(bev.aggregate_bev_cells, make_scenes(r)))
        reqs.append(bev.pack_cells_batched(list(cells_l), list(keys_l),
                                           max(len(c) for c in cells_l)))
    two(path1, *reqs[0], BATCH)  # builds the second replica
    torch.cuda.synchronize()
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    outs = [two(path1, *req, BATCH) for req in reqs]
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in fns.items()}
    want = {k: 2 * n * len(reqs) for k, n in LAUNCHES_PATH1.items()}
    half = BATCH // 2
    exact, summary = True, []
    for req, (dets, masks) in zip(reqs, outs):
        parts = [one(path1, *(x[i * half:(i + 1) * half] for x in req), half) for i in range(2)]
        exact &= (torch.equal(dets, torch.cat([d for d, _ in parts]))
                  and torch.equal(masks, torch.cat([m for _, m in parts])))
        d8, m8 = one(path1, *req, BATCH)
        summary.append((masks.sum(1).int().tolist(), m8.sum(1).int().tolist()))
    print(f"[ddp] (c) path 1 over 2 replicas on {dev} (batched COO, 4 + 4 frames), "
          f"{len(reqs)} requests of {BATCH}: launches {got} (want {want}: stem 1, 3x3 5 and NMS "
          f"2 per replica per request); detections equal to the one-device function on each "
          f"replica's 4 frames: {exact}; detections per frame split vs one device at batch "
          f"{BATCH}: {summary}")
    if got != want or not exact:
        raise AssertionError("phase 8 (c): the two-replica serve differs or missed a kernel")
    return got


# ------------------------------------------------------------- phase 9 ----

def export_artifacts(argv):
    """Phase 9's exporter, one process per job (``chip_smoke.py --export-pt2
    OUT_DIR JOB``), all started beside nvcc at the lowest CPU priority:
    tracing runs the ops' fake implementations and needs no kernel. Each
    builds complex_yolov4's seed-0 weights once. JOB is a name of
    EXPORT_ARTIFACTS, (a, b): `cli.export.export_pt2` (what ``cli.export
    --format pt2`` runs before its round trip; the server's load is this
    artifact's) at batch BATCH, 608, phase 4's thresholds, into
    OUT_DIR/<name>.pt2; or "formats", (c): `cli.export.write_weights` for
    darknet and ckpt (what ``--format darknet|ckpt`` runs), each read back
    through `cli.common.load_weights` and held equal to the weights. Prints
    one JSON line after "[export] ": the job's seconds by step and the
    wall-clock time it began its work and ended (`time.time()`)."""
    import os

    began = time.time()
    os.nice(19)
    out_dir, job = argv
    t0 = time.perf_counter()
    from complex_yolov4_tpu_torch.cli import common, export
    from complex_yolov4_tpu_torch.models import weights, zoo

    t1 = time.perf_counter()
    spec = zoo.get_model_spec(MODEL)
    params, state = weights.init_params_np(spec, SEED)
    record = {"job": job, "began": began, "import_s": t1 - t0,
              "weights_s": time.perf_counter() - t1, "cpus": len(os.sched_getaffinity(0))}
    if job == "formats":
        for fmt, ext in (("darknet", "weights"), ("ckpt", "ckpt")):
            path = os.path.join(out_dir, f"model.{ext}")
            t0 = time.perf_counter()
            export.write_weights(fmt, spec, params, state, path)
            t1 = time.perf_counter()
            got_p, got_s = common.load_weights(spec, path)
            record[fmt] = all(
                set(got[k]) == set(ref[k]) and all(np.array_equal(np.asarray(got[k][leaf]),
                                                                  np.asarray(ref[k][leaf]))
                                                   for leaf in ref[k])
                for got, ref in ((got_p, params), (got_s, state)) for k in ref) and (
                set(got_p) == set(params) and set(got_s) == set(state))
            record.update({f"{fmt}_mb": os.path.getsize(path) / 2 ** 20,
                           f"{fmt}_write_s": t1 - t0,
                           f"{fmt}_read_s": time.perf_counter() - t1})
    else:
        kwargs, fused = next((kw, f) for name, kw, f in EXPORT_ARTIFACTS if name == job)
        if fused:
            os.environ["FUSED_STAGE"] = "1"
        record.update(export.export_pt2(
            spec, params, state, os.path.join(out_dir, f"{job}.pt2"),
            device=torch.device("cuda", 0), batch=BATCH, img_size=608, conf_thresh=0.5,
            nms_thresh=0.5, max_boxes=64, **kwargs))
    record["ended"] = time.time()
    print("[export] " + json.dumps(record), flush=True)


def start_exporters(tmp):
    """Start one `export_artifacts` process per EXPORT_JOBS -> (processes,
    OUT_DIR, the wall-clock time they started); job J logs to
    OUT_DIR/export_J.log."""
    import os

    out_dir = os.path.join(tmp, "export_out")
    os.makedirs(out_dir)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("FUSED_STAGE", None)
    started, procs = time.time(), []
    for job in EXPORT_JOBS:
        with open(os.path.join(out_dir, f"export_{job}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--export-pt2", out_dir, job],
                cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, out_dir, started


def wait_exporters(exporters):
    """Wait for every exporter process (`_wait_proc`); returns the wall
    seconds from their start to the last one's end."""
    import os

    procs, out_dir, started = exporters
    for job, proc in zip(EXPORT_JOBS, procs):
        _wait_proc(proc, os.path.join(out_dir, f"export_{job}.log"), f"exporter ({job})")
    return time.time() - started


def serve_artifacts(argv):
    """Phase 9's server, a fresh process (``chip_smoke.py --serve-pt2
    OUT_DIR``) that imports torch and the port's ops and nothing else of the
    port: it loads each artifact with `torch.export.load` (timed), writes
    OUT_DIR/ready, and waits for OUT_DIR/go (written once the main process
    has timed the eager path). Then per artifact: one warm-up call on the
    first batch of its inputs (OUT_DIR/<input>.pt), the launch counts set to
    0, every batch served and synced (each timed), the counts read; the
    detections go to OUT_DIR/out_<name>.pt. Prints one JSON line per
    artifact after "[serve] "."""
    import os

    import complex_yolov4_tpu_torch.ops  # noqa: F401  (registers the custom ops)

    out_dir = argv[0]
    dev = torch.device("cuda", 0)
    loaded, load_s = {}, {}
    for name, _, _ in EXPORT_ARTIFACTS:
        t0 = time.perf_counter()
        loaded[name] = torch.export.load(os.path.join(out_dir, f"{name}.pt2")).module()
        load_s[name] = time.perf_counter() - t0
    _signal(os.path.join(out_dir, "ready"))
    _wait_for_file(os.path.join(out_dir, "go"), EXPORT_TIMEOUT_S)
    fns = counters()
    for name, _, _ in EXPORT_ARTIFACTS:
        batches = torch.load(os.path.join(out_dir, f"{name.split('_')[0]}.pt"))
        prog = loaded[name]
        with torch.no_grad():
            prog(*(x.to(dev) for x in batches[0]))
            torch.cuda.synchronize()
            for fn in fns.values():
                fn.launches = 0
            outs, ms = [], []
            for inputs in batches:
                xs = [x.to(dev) for x in inputs]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets, masks = prog(*xs)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append((dets.cpu(), masks.cpu()))
        torch.save(outs, os.path.join(out_dir, f"out_{name}.pt"))
        print("[serve] " + json.dumps({"name": name, "load_s": load_s[name], "ms": ms,
                                       "launches": {k: fn.launches for k, fn in fns.items()},
                                       "calls": len(batches)}), flush=True)


def _records(path, tag):
    with open(path) as f:
        out = f.read()
    return out, [json.loads(line[len(tag):]) for line in out.splitlines()
                 if line.startswith(tag)]


def _wait_proc(proc, log, what):
    """Wait for a phase-9 process within EXPORT_TIMEOUT_S (killed when it runs
    out); raise, with the end of its log, if it failed."""
    try:
        proc.wait(timeout=EXPORT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"phase 9: the {what} did not finish in {EXPORT_TIMEOUT_S} s")
    if proc.returncode != 0:
        with open(log) as f:
            print(f.read()[-6000:])
        raise AssertionError(f"phase 9: the {what} exited {proc.returncode}")


def phase_export(dev, exporter, roots, smi):
    """Phase 9: the exported serving programs against the eager path, the
    weight formats, and find_anchors on the card. Returns the artifacts'
    launches by run."""
    import os

    from complex_yolov4_tpu_torch.cli import find_anchors
    from complex_yolov4_tpu_torch.data import loader as ld
    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.models.network import Darknet

    _, out_dir, started = exporter  # every exporter ended before phase 3 (`main`)
    exp = {job: _records(os.path.join(out_dir, f"export_{job}.log"), "[export] ")[1][-1]
           for job in EXPORT_JOBS}
    for job, t in exp.items():
        print(f"[export] job {job}: started {t['began'] - started:.2f} s after the launch, "
              f"imports {t['import_s']:.2f} s, seed-0 weights {t['weights_s']:.2f} s, ended "
              f"{t['ended'] - started:.2f} s after the launch ({t['cpus']} CPUs; beside nvcc, "
              f"at the lowest CPU priority; {smi})")
    for name, _, fused in EXPORT_ARTIFACTS:
        t = exp[name]
        print(f"[export] {name}{' (FUSED_STAGE=1)' if fused else ''}: cli.export export_pt2 "
              f"{MODEL} @608 batch {BATCH}: trace {t['export_s']:.2f} s, save "
              f"{t['save_s']:.2f} s, {t['mb']:.1f} MB ({smi})")
    t = exp["formats"]
    print(f"[export] (c) darknet ({t['darknet_mb']:.1f} MB, write {t['darknet_write_s']:.2f} s, "
          f"read {t['darknet_read_s']:.2f} s) read back equal: {t['darknet']}; ckpt "
          f"({t['ckpt_mb']:.1f} MB, write {t['ckpt_write_s']:.2f} s, read "
          f"{t['ckpt_read_s']:.2f} s) read back equal: {t['ckpt']} ({smi})")
    if not (t["darknet"] and t["ckpt"]):
        raise AssertionError("phase 9 (c): a weight format did not read back equal")

    # inputs: phase 4's 8 requests as rasters; phase 5's val frames as padded points
    images = [(raster(host_coo(make_scenes(r)), dev, BATCH).cpu(),) for r in range(REQUESTS)]
    points = [(torch.as_tensor(b["points"]), torch.as_tensor(b["point_mask"]))
              for b in ld.create_val_loader(roots["eval"], BATCH, device_raster=True)]
    torch.save(images, os.path.join(out_dir, "image.pt"))
    torch.save(points, os.path.join(out_dir, "points.pt"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    serve_log = os.path.join(out_dir, "serve.log")
    with open(serve_log, "w") as f:
        server = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve-pt2",
                                   out_dir], cwd=here, env=env, stdout=f,
                                  stderr=subprocess.STDOUT)
    try:
        spec = zoo.get_model_spec(MODEL)
        params, state = weights.init_params_np(spec, SEED)
        st = weights.from_folded(spec, weights.fold_batchnorm(spec, params, state))
        models = {False: Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev),
                  True: Darknet(spec, st, compute_dtype=torch.bfloat16, device=dev,
                                fused_stages=True)}
        zeros = {"flip": torch.zeros((BATCH,)), "holes": torch.zeros((BATCH, 0, 5)),
                 "hole_mask": torch.zeros((BATCH, 0))}
        eager_out, eager_ms = {}, {}
        for name, _, fused in EXPORT_ARTIFACTS:
            from_points = name != "image"
            infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64,
                                      from_points=from_points)

            def run(inputs, model=models[fused], infer=infer, from_points=from_points):
                xs = [x.to(dev) for x in inputs]
                if from_points:
                    xs += [v.to(dev) for v in zeros.values()]
                return infer(model, *xs)

            batches = points if from_points else images
            eager_out[name] = [tuple(t.cpu() for t in run(b)) for b in batches]
        _wait_for_file(os.path.join(out_dir, "ready"), EXPORT_TIMEOUT_S)
        for name, _, fused in EXPORT_ARTIFACTS:  # timed while the server waits
            from_points = name != "image"
            infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64,
                                      from_points=from_points)
            ms = []
            for inputs in (points if from_points else images):
                xs = [x.to(dev) for x in inputs]
                if from_points:
                    xs += [v.to(dev) for v in zeros.values()]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                infer(models[fused], *xs)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            eager_ms[name] = ms
        del models
        torch.cuda.empty_cache()
        _signal(os.path.join(out_dir, "go"))
        _wait_proc(server, serve_log, "server")
    except BaseException:
        server.kill()
        server.wait()
        raise
    _, served = _records(serve_log, "[serve] ")
    runs, failed = {}, []
    for rec in served:
        name = rec["name"]
        fused = dict((n, f) for n, _, f in EXPORT_ARTIFACTS)[name]
        got = torch.load(os.path.join(out_dir, f"out_{name}.pt"))
        want = eager_out[name]
        keep_equal = all(torch.equal(gm, wm) for (_, gm), (_, wm) in zip(got, want))
        err = max(float((gd - wd).abs().max()) for (gd, _), (wd, _) in zip(got, want))
        bit_equal = keep_equal and err == 0.0
        per_call = LAUNCHES_FUSED if fused else {**LAUNCHES_PATH1, "nms": 0}
        want_l = {k: v * rec["calls"] for k, v in per_call.items()}
        live = [int(m.sum()) for _, m in got]
        warm_pt2, warm_eager = float(np.mean(rec["ms"])), float(np.mean(eager_ms[name]))
        print(f"[export] (a, b) {name}: loaded in a fresh process in {rec['load_s']:.2f} s; "
              f"{rec['calls']} batches of {BATCH}: launches {rec['launches']} (want {want_l}); "
              f"live detections per batch {live}; keep sets equal to the eager "
              f"make_inference_fn: {keep_equal}, max |box diff| {err:.3g} px (tol "
              f"{EXPORT_BOX_TOL}), bit-equal {bit_equal}; ms per batch (synced) loaded program "
              + " ".join(f"{x:.3f}" for x in rec["ms"]) + f" (mean {warm_pt2:.3f}), eager "
              + " ".join(f"{x:.3f}" for x in eager_ms[name])
              + f" (mean {warm_eager:.3f}; both warm: every batch was served once before; "
              f"{smi})")
        if rec["launches"] != want_l or not keep_equal or err > EXPORT_BOX_TOL or not sum(live):
            failed.append(name)
        runs[f"export pt2 {name}"] = rec["launches"]
    if failed or len(served) != len(EXPORT_ARTIFACTS):
        raise AssertionError(f"phase 9: exported programs {failed} differ from the eager path "
                             "or missed a kernel")

    # (d) find_anchors on the card against the CPU
    t0 = time.perf_counter()
    a_gpu, iou_gpu = find_anchors.main(["--dataset_dir", roots["train"], "--device", "cuda"])
    t1 = time.perf_counter()
    a_cpu, iou_cpu = find_anchors.main(["--dataset_dir", roots["train"], "--device", "cpu"])
    t2 = time.perf_counter()
    a_err = float(np.abs(a_gpu - a_cpu).max())
    print(f"[export] (d) find_anchors on phase 6's {TRAIN_FRAMES} train frames: anchors "
          f"cuda vs cpu max |diff| {a_err:.3g} (tol {ANCHOR_TOL}), avg IoU {iou_gpu:.6f} vs "
          f"{iou_cpu:.6f}; {t1 - t0:.2f} s on cuda, {t2 - t1:.2f} s on cpu ({smi})")
    if a_err > ANCHOR_TOL or abs(iou_gpu - iou_cpu) > ANCHOR_TOL:
        raise AssertionError("phase 9 (d): find_anchors on the card differs from the CPU")
    return runs


def main() -> None:
    import os

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
    # phase 8's gloo pair starts now: its imports, group and weights take
    # host time beside nvcc, and it waits for phase 8 on the card
    ranks = start_ddp_ranks(tmp)
    # phase 9's exporters trace the serving programs beside nvcc too
    exporter = start_exporters(tmp)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            host = pool.submit(host_side, tmp)
            phase_build()
            roots = host.result()  # raises if g++ failed or a native check did
        dynamo.join()
        # the exporters must be done before the phases that time the host
        export_s = wait_exporters(exporter)
        lap(f"phases 1-2 (device, build; phase 7 a, b, d, phase 8's gloo pair and phase 9's "
            f"exporters beside it, the last exporter done {export_s:.1f} s after their start)")
        records = phase_kernels(dev)
        lap("phase 3 (stem and 3x3 kernels)")
        records["fused_stage"] = phase_fused(dev)
        lap("phase 3 (fused stage)")
        records["int8_conv"], records[INT8_F32_ROW] = phase_int8(dev)
        lap("phase 3 (int8 conv)")
        records[NMS_ROW] = phase_nms(dev)
        lap("phase 3 (NMS)")
        spec, state, path1, path2 = build_models(dev)
        l1 = serve_path("path 1 (bf16)", spec, path1, LAUNCHES_PATH1, BATCH, dev)
        l8 = phase_ddp_serve(path1, dev)
        layerwise_segments(path1, dev)
        l2 = serve_path("path 2 (int8 + fused stages)", spec, path2, LAUNCHES_PATH2, 2, dev)
        if "--split" in sys.argv[1:]:
            phase_split("path1", path1, dev)
            phase_split("path2", path2, dev)
        phase_sighted(dev, state, path1, path2)
        del state, path1, path2
        torch.cuda.empty_cache()
        lap("phase 4 (slice; phase 7 c: served with numpy and native COO; phase 8 c; s: "
            "sighted checks)")
        runs = {"serve path 1": l1, "serve path 2": l2, "serve path 1 on 2 replicas": l8,
                **{f"eval {k}": v for k, v in phase_evaluate(dev, roots["eval"]).items()}}
        lap("phase 5 (evaluate)")
        f32_runs = phase_train(dev, tmp, roots["train"])
        lap("phase 6 (train)")
        runs["train mosaic"] = phase_train_flags(dev, tmp, roots["mosaic"])
        lap("phase 7 (e-g: mosaic training, profiler, remat)")
        runs["test cli"] = phase_test_cli(dev, tmp, roots["test"])
        lap("phase 7 (h: cli.test)")
        torch.cuda.empty_cache()
        f32_runs["ddp cli.train (lead's f32 validation)"] = phase_ddp_gloo(
            dev, ranks, roots["train"])
        lap("phase 8 (a: NCCL, one rank; b, d: the gloo pair)")
        runs.update(phase_export(dev, exporter, roots, smi))
        lap("phase 9 (export and tools)")
    except BaseException:
        kill_ranks(ranks[0] + exporter[0])
        raise
    finally:
        tmp_dir.cleanup()
    print(f"[time] phases 1-9: {time.perf_counter() - t_start:.1f} s")
    kernels = []
    f32_of = {F32_ROW: "conv3x3_fused", INT8_F32_ROW: "int8_conv"}
    for k in KERNEL_NAMES + tuple(f32_of):
        r = records[k]
        if k in f32_of:
            launches = sum(run[f32_of[k]] for run in f32_runs.values())
        elif k == NMS_ROW:  # f32 heads in the bf16 and f32 runs alike
            launches = sum(run[k] for run in {**runs, **f32_runs}.values())
        else:
            launches = sum(run[k] for run in runs.values())
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
        if "device_ms" in r:
            row["device_ms"] = r["device_ms"]
        kernels.append(row)
    print("[kernels] launches per run: " + "; ".join(
        f"{name} {run}" for name, run in {**runs, **f32_runs}.items()))
    print("[kernels] launches: the bf16 runs of phases 4, 5, 7, 8 (c) and 9 together, and for "
          f"{F32_ROW} and {INT8_F32_ROW} the f32 runs of phases 6 and 8 (d); ms, plain_ms, "
          "bound_ms and "
          "library_ms: per request of 8 frames, summed over the main-path layers each kernel "
          "takes (3x3 in bf16 and f32: layers 1, 6, 11, 16, 19; fused stage: segments 2-10 and "
          "12-23; int8: "
          "the 68 quantized convs, but library_ms over its library_layers 1x1 convs only, "
          "on which the kernel takes ms_on_library_layers); bound_by: what bounds the layers "
          f"holding most of bound_ms; {NMS_ROW}: one call at the served shape (16 frames, k=64), "
          "launches over the bf16 and f32 runs together")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["--export-pt2"]:
        export_artifacts(sys.argv[2:])
    elif sys.argv[1:2] == ["--serve-pt2"]:
        serve_artifacts(sys.argv[2:])
    else:
        main()
