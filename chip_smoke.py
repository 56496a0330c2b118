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
   - the fused-stage kernel at (8, 304, 304, 64) segment 2-10 and (8, 152,
     152, 128) segment 12-23, the segments of complex_yolov4_tiny and
     complex_yolov3, and one 76-px batch-2 case (ragged tiles): max |diff|
     <= 1e-2 * max |plain| (both round to bf16 after every op);
   - the int8 kernel at each distinct (k, stride, C_in, C_out, H) of the
     68 quantized convs of complex_yolov4 at 608, batch 8: int32 sums
     equal, bf16 outputs within 1 ulp, requantized int8 within 1;
4. slice — complex_yolov4 at 608, full width, bf16, random weights from
   seed 0, serves 4 requests of 8 synthetic scenes through the port's
   `make_inference_fn(from_cells=True)` (host COO aggregation, device
   raster, network, decode, rotated NMS at k=64, conf 0.5, nms 0.5), on
   two paths, each with the launch counts set to 0 just before it:
   - path 1, bf16: the stem kernel must launch once and the 3x3 kernel
     five times per request;
   - path 2, int8 PTQ (`default_skip`, calibrated on 2 synthetic frames)
     with both fused CSP stages: stem 1, 3x3 2, fused stage 2 and int8
     conv 68 launches per request;
   on each path the decoded heads of the kernel path are compared with the
   all-plain path on the card (path 2 at batch 2: the plain int8 convs run
   in float64).

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record, and the line before that nvidia-smi's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8
REQUESTS = 4
SEED = 0
# (name, H=W in, C_in, C_out, stride) of the 3x3-kernel layers at 608
CONV3X3_LAYERS = (("L1", 608, 32, 64, 2), ("L6", 304, 32, 64, 1),
                  ("L11", 304, 64, 128, 2), ("L16", 152, 64, 64, 1),
                  ("L19", 152, 64, 64, 1))
# decoded-head comparison, kernel path vs plain path (both bf16 on the card):
# per-column max |diff| relative to the column's scale, and abs on conf/cls
DECODED_REL_TOL = 2e-2
PROB_ABS_TOL = 1e-2
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
# H100 over seeds 0-5 the main-path segments read 0.0045-0.0091 of max
# |plain|: at most 2 bf16 steps of values in [0.5, 1).
FUSED_REL_TOL = 1e-2
# (model, segment span, H=W, batch): the main-path segments first
FUSED_CASES = (("complex_yolov4", (2, 10), 304, 8), ("complex_yolov4", (12, 23), 152, 8),
               ("complex_yolov4_tiny", (2, 8), 152, 8), ("complex_yolov3", (2, 4), 304, 8),
               ("complex_yolov3", (6, 11), 152, 8), ("complex_yolov4", (12, 23), 76, 2))
KERNEL_NAMES = ("stem_conv3x3", "conv3x3_fused", "fused_stage", "int8_conv")
SOURCES = {"stem_conv3x3": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           "conv3x3_fused": "complex_yolov4_tpu_torch/csrc/conv3x3.cu",
           "fused_stage": "complex_yolov4_tpu_torch/csrc/fused_stage.cu",
           "int8_conv": "complex_yolov4_tpu_torch/csrc/int8_conv.cu"}
REPLACES = {"stem_conv3x3": "complex_yolov4_tpu/ops/stem_conv.py:112",
            "conv3x3_fused": "complex_yolov4_tpu/ops/pallas_conv.py:92",
            "fused_stage": "complex_yolov4_tpu/ops/fused_stage.py:495",
            "int8_conv": "complex_yolov4_tpu/models/network.py:456"}


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


def timed_pair(kernel_fn, plain_fn, reps: int):
    """Kernel and plain ms, measured in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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

    def operands(hw, c_in, c_out, x_dtype):
        x = rng.uniform(0.0, 1.0, (BATCH, hw, hw, c_in)) if x_dtype == torch.float32 \
            else rng.normal(0.0, 1.0, (BATCH, hw, hw, c_in))
        bound = float(np.sqrt(1.0 / (9 * c_in)))
        w = rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32)
        b = rng.normal(0.0, 0.1, c_out).astype(np.float32)
        return (torch.from_numpy(x.astype(np.float32)).to(dev, x_dtype),
                conv_mod.pack_weight(torch.from_numpy(w)).to(dev),
                torch.from_numpy(b).to(dev))

    results = []
    x, w, b = operands(608, 3, 32, torch.float32)
    k_out = stem_mod.conv3x3_stem(x, w, b, activation="mish")
    torch.cuda.synchronize()
    p_out = stem_mod.stem_plain(x, w, b, activation="mish")
    torch.cuda.synchronize()
    results.append(("stem L0", tuple(x.shape), 32, 1, k_out, p_out,
                    *timed_pair(lambda: stem_mod.conv3x3_stem(x, w, b, activation="mish"),
                                lambda: stem_mod.stem_plain(x, w, b, activation="mish"), 20)))
    for name, hw, c_in, c_out, stride in CONV3X3_LAYERS:
        x, w, b = operands(hw, c_in, c_out, torch.bfloat16)
        kw = {"stride": stride, "activation": "mish"}
        k_out = conv_mod.conv3x3_fused(x, w, b, **kw)
        torch.cuda.synchronize()
        p_out = conv_mod.conv3x3_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        results.append((f"conv3x3 {name}", tuple(x.shape), c_out, stride, k_out, p_out,
                        *timed_pair(lambda: conv_mod.conv3x3_fused(x, w, b, **kw),
                                    lambda: conv_mod.conv3x3_plain(x, w, b, **kw), 10)))
        del x, w, b

    records = {}
    failed = []
    for name, shape, c_out, stride, k_out, p_out, k_ms, p_ms in results:
        abs_err, ulps = bf16_ulp_error(k_out, p_out)
        ok = (k_out.shape == p_out.shape and k_out.dtype == torch.bfloat16
              and bool(torch.isfinite(k_out.float()).all()) and ulps <= 1.0)
        print(f"[kernels] {name} x{shape} -> {c_out} s{stride}: max_abs_err={abs_err:.6g} "
              f"max_err_ulps={ulps:.3f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        key = "stem_conv3x3" if name.startswith("stem") else "conv3x3_fused"
        r = records.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
    if failed:
        raise AssertionError(f"kernel vs plain disagree beyond 1 bf16 ulp: {failed}")
    return records


def phase_fused(dev):
    """Fused-stage kernel vs its plain version; ms per request (batch 8) is
    the sum over the two main-path segments."""
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    failed = []
    for n, (name, span, hw, batch) in enumerate(FUSED_CASES):
        spec = zoo.get_model_spec(name)
        params, state = weights.init_params_np(spec, SEED)
        st = {k: v.to(dev) for k, v in weights.from_jax_params(spec, params, state).items()}
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
            timing = f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
        lay = sw.layout
        print(f"[kernels] fused_stage {name} {span[0]}-{span[1]} x{tuple(x.shape)} -> "
              f"{seg.cout}: window {lay.win_h}x{lay.win_w} halo {lay.halo} "
              f"smem {lay.smem_bytes} B; max_abs_err={err:.6g} "
              f"(tol {FUSED_REL_TOL} * {scale:.4g}){timing} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {span}")
        del x, got, ref
    if failed:
        raise AssertionError(f"fused stage vs plain beyond tolerance: {failed}")
    return rec


def int8_shapes():
    """{(k, stride, C_in, C_out, H_in): count} over complex_yolov4's
    quantized convs at 608 (`default_skip`)."""
    from complex_yolov4_tpu_torch.models import quantize as qz
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.spec import ConvSpec

    spec = zoo.get_model_spec(MODEL)
    chans = (spec.in_channels,) + spec.out_channels()
    strides = spec.out_strides()
    skip = qz.default_skip(spec)
    shapes = {}
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, ConvSpec) and i not in skip:
            key = (layer.size, layer.stride, chans[i], layer.filters, 608 // strides[i - 1])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_int8(dev):
    """int8 kernel vs its plain version at every distinct quantized shape,
    batch 8, in the int32, bf16 and int8 output modes; ms per request is
    the bf16-mode time summed over the 68 layers."""
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    shapes = int8_shapes()
    assert sum(shapes.values()) == 68, shapes
    rng = np.random.default_rng(SEED)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    failed = []
    for (k, stride, c_in, c_out, hw), count in sorted(shapes.items()):
        x = torch.from_numpy(rng.integers(-127, 128, (BATCH, hw, hw, c_in)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (c_out, k * k * c_in)).astype(np.int8)).to(dev)
        # scales of a real layer: |h| of order 1 for |y| ~ sqrt(K) * 127^2 / 3
        s_w = rng.uniform(0.5, 1.5, c_out) / (127.0 * np.sqrt(k * k * c_in))
        scale = torch.from_numpy(s_w.astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0.0, 0.1, c_out).astype(np.float32)).to(dev)
        kw = {"ksize": k, "stride": stride, "s_x": float(np.float32(2.0 / 127.0)),
              "activation": "mish"}
        inv_next = float(np.float32(1.0) / np.float32(3.0 / 127.0))
        g32 = i8.int8_conv(x, w, scale, b, out="int32", **kw)
        gbf = i8.int8_conv(x, w, scale, b, **kw)
        gi8 = i8.int8_conv(x, w, scale, b, out="int8", inv_s_next=inv_next, **kw)
        torch.cuda.synchronize()
        p32 = i8.int8_conv_plain(x, w, scale, b, out="int32", **kw)
        pbf = i8.epilogue(p32, scale, b, s_x=kw["s_x"], activation="mish", out="bf16")
        pi8 = i8.epilogue(p32, scale, b, s_x=kw["s_x"], activation="mish", out="int8",
                          inv_s_next=inv_next)
        torch.cuda.synchronize()
        eq32 = torch.equal(g32, p32)
        abs_err, ulps = bf16_ulp_error(gbf, pbf)
        d8 = int((gi8.int() - pi8.int()).abs().max())
        k_ms, p_ms = timed_pair(lambda: i8.int8_conv(x, w, scale, b, **kw),
                                lambda: i8.int8_conv_plain(x, w, scale, b, **kw), 5)
        ok = eq32 and ulps <= 1.0 and d8 <= 1 and bool(torch.isfinite(gbf.float()).all())
        print(f"[kernels] int8_conv k{k} s{stride} {c_in}->{c_out} @{hw} x{count}: "
              f"int32_equal={eq32} bf16 max_abs_err={abs_err:.6g} max_err_ulps={ulps:.3f} "
              f"int8 max_diff={d8} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((k, stride, c_in, c_out, hw))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        rec["ms"] += k_ms * count
        rec["plain_ms"] += p_ms * count
        del x, w, g32, gbf, gi8, p32, pbf, pi8
    if failed:
        raise AssertionError(f"int8 kernel vs plain disagree: {failed}")
    return rec


def make_scenes(r: int):
    """Set-up, untimed: the 8 cropped synthetic point clouds of request r."""
    from complex_yolov4_tpu_torch.data import bev, synthetic

    return [bev.remove_points_outside(
        synthetic.sample_scene(np.random.default_rng(1000 * (r + 1) + b))[0])
        for b in range(BATCH)]


def host_coo(clouds):
    """Host side of one request: cropped clouds -> flat COO arrays, with the
    serving capacity policy (live cells + 1/8 headroom)."""
    from complex_yolov4_tpu_torch.data import bev

    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
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
    """Serve REQUESTS requests of BATCH through make_inference_fn; the
    launch counts are set to 0 just before and read just after. Returns
    the launches and the device-part ms of each request."""
    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn

    routes = model.routes(608)
    kinds = {}
    for r in routes.values():
        kinds[r] = kinds.get(r, 0) + 1
    print(f"[slice] {label}: {MODEL} @608 bf16, {len(spec.layers)} layers, "
          f"routed layers by kernel {kinds}")
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64)
    scenes = [make_scenes(r) for r in range(REQUESTS)]
    infer(model, *host_coo(make_scenes(-1)), BATCH)  # warm-up
    torch.cuda.synchronize()

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    host_s, infer_s, outs = [], [], []
    for r in range(REQUESTS):
        t0 = time.perf_counter()
        req = host_coo(scenes[r])
        t1 = time.perf_counter()
        dets, masks = infer(model, *req, BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host_s.append(t1 - t0)
        infer_s.append(t2 - t1)
        outs.append((req, dets, masks))
    launches = {k: fn.launches for k, fn in fns.items()}
    print(f"[slice] {label} launches over {REQUESTS} requests: {launches}")
    want = {k: n * REQUESTS for k, n in expected.items()}
    if launches != want:
        raise AssertionError(f"{label} did not run through the kernels: {launches} != {want}")

    for r, (req, dets, masks) in enumerate(outs):
        if tuple(dets.shape) != (BATCH, 64, 9) or tuple(masks.shape) != (BATCH, 64):
            raise AssertionError(f"request {r}: shapes {tuple(dets.shape)} {tuple(masks.shape)}")
        if not bool(torch.isfinite(dets).all()):
            raise AssertionError(f"request {r}: non-finite detections")
        print(f"[slice] {label} request {r}: cells={int((req[0] < BATCH * 609 * 609).sum())} "
              f"detections/frame={masks.sum(1).int().tolist()} "
              f"host_ms={host_s[r] * 1e3:.2f} infer_ms={infer_s[r] * 1e3:.2f}")
    e2e = np.array(host_s) + np.array(infer_s)
    print(f"[slice] {label} ms/request e2e (host COO + device) mean={e2e.mean() * 1e3:.2f} "
          f"frames/s={BATCH / e2e.mean():.2f}; device part (raster..NMS) "
          f"mean={np.mean(infer_s) * 1e3:.2f} ms frames/s={BATCH / np.mean(infer_s):.2f}")

    # decoded heads: kernel path vs all-plain path on the card
    with torch.inference_mode():
        img = raster(outs[0][0], dev, BATCH)[:compare_batch].permute(0, 3, 1, 2)
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
    return launches, infer_s


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
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64)
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


def main() -> None:
    name, count, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    records = phase_kernels(dev)
    records["fused_stage"] = phase_fused(dev)
    records["int8_conv"] = phase_int8(dev)
    spec, path1, path2 = build_models(dev)
    l1, _ = serve_path("path 1 (bf16)", spec, path1, LAUNCHES_PATH1, BATCH, dev)
    layerwise_segments(path1, dev)
    l2, _ = serve_path("path 2 (int8 + fused stages)", spec, path2, LAUNCHES_PATH2, 2, dev)
    if "--split" in sys.argv[1:]:
        phase_split("path1", path1, dev)
        phase_split("path2", path2, dev)
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
                "launches": l1[k] + l2[k], "max_abs_err": records[k]["max_abs_err"],
                "ms": records[k]["ms"], "plain_ms": records[k]["plain_ms"]}
               for k in KERNEL_NAMES]
    print("[kernels] launches: paths 1 and 2 together; ms and plain_ms: per request of 8 "
          "frames, summed over the main-path layers each kernel takes (3x3: layers 1, 6, 11, "
          "16, 19; fused stage: segments 2-10 and 12-23; int8: the 68 quantized convs)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
