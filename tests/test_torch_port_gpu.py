"""Port CUDA kernels on the card vs their plain PyTorch versions; the
device points raster, the eval and train CLIs and TF32 on the card.

Marked `gpu`: each test skips without a CUDA device (decided inside the
test, so every worker collects the same tests). Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_port_gpu.py

(`--noconftest`: the repo's conftest imports JAX, which the GPU host lacks;
this file imports only torch and the port.) Conv kernel and plain version
see the same bf16 operands and both accumulate in f32, so they agree to one
bf16 ulp; values below 2^-10 of the tensor's largest, where the sum
cancels, are held to the ulp of that floor. The f32 instance of the 3x3
kernel and its plain version round the same f32 input to bf16 and keep f32
sums and outputs, so they agree within 1e-4 of max |plain|. The
fused-stage and int8 tests state their own bounds.
"""

import numpy as np
import pytest
import torch

from complex_yolov4_tpu_torch.ops import conv3x3 as conv_mod
from complex_yolov4_tpu_torch.ops import stem_conv as stem_mod
from tests._torch_port_util import capped_threads  # noqa: F401
from tests._torch_port_util import nms_heads, nms_near_threshold

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _max_ulps(got, ref, floor_frac=2.0 ** -10):
    g, r = got.float(), ref.float()
    floor = r.abs().max().clamp(min=1e-30) * floor_frac
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(r.abs(), floor))) - 7.0)
    return float(((g - r).abs() / ulp).max())


def _operands(dev, b, hw, c_in, c_out, x_dtype, seed=0, fill="rand"):
    """hw: H = W, or (H, W). fill "ones": every input and weight 1, bias 0."""
    h, w_ = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (b, h, w_, c_in)).astype(np.float32)
    bound = float(np.sqrt(1.0 / (9 * c_in)))
    w = rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c_out).astype(np.float32)
    if fill == "ones":
        x, w, bias = np.ones_like(x), np.ones_like(w), np.zeros_like(bias)
    return (torch.from_numpy(x).to(dev, x_dtype), conv_mod.pack_weight(torch.from_numpy(w)).to(dev),
            torch.from_numpy(bias).to(dev))


def _check_ones(got, c_in):
    """All-ones input and weights, linear, stride 1: a corner sees 4 taps,
    an edge 6, the inside 9 — a halo or zero-fill slip shows exactly."""
    g = got.float()[..., 0]
    h, w = g.shape[1:]
    for y, x, taps in ((0, 0, 4), (h - 1, w - 1, 4), (0, w // 2, 6), (h // 2, 0, 6),
                       (h - 1, w // 2, 6), (h // 2, w - 1, 6), (h // 2, w // 2, 9)):
        assert bool((g[:, y, x] == taps * c_in).all()), (y, x, taps)


# Each warp's tiles are 2 x 32 pixels: 136 and 200 leave ragged tiles;
# C_out 96 leaves one warp group idle; batch 1 and 3. The kernel is built
# for C_in 3, which loads windows by TMA (the box starts 1 float before the
# row), and 14, which copies them with 4-byte cp.async; the wrapper
# zero-pads 6 and 12 to 14.
@pytest.mark.parametrize("c_in,c_out,act,hw,batch,fill", [
    (3, 32, "mish", 128, 2, "rand"), (6, 64, "leaky", 136, 2, "rand"),
    (12, 128, "linear", 64, 2, "rand"), (14, 128, "relu", 40, 2, "rand"),
    (3, 32, "mish", (608, 200), 1, "rand"), (14, 96, "mish", (608, 200), 3, "rand"),
    (3, 32, "linear", (130, 136), 1, "ones")])
def test_stem_kernel_matches_plain(c_in, c_out, act, hw, batch, fill):
    dev = _cuda()
    x, w, b = _operands(dev, batch, hw, c_in, c_out, torch.float32, fill=fill)
    n0 = stem_mod.conv3x3_stem.launches
    got = stem_mod.conv3x3_stem(x, w, b, activation=act)
    torch.cuda.synchronize()
    assert stem_mod.conv3x3_stem.launches == n0 + 1
    ref = stem_mod.stem_plain(x, w, b, activation=act)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _max_ulps(got, ref) <= 1.0
    if fill == "ones":
        _check_ones(got, c_in)


# Tiles are 4 x 16 output pixels x 64 channels, one per warpgroup on wgmma
# (one per block on mma.sync where two window rings do not fit): 130 x 136
# (stride 1) and 130 x 268 (stride 2, 65 x 134 out) leave ragged tiles;
# L1's and L11's exact shapes at batch 1; C_in 32 and 64 load windows by
# TMA in the 64- and 128-byte swizzles; the wrapper zero-pads C_in 3, 12,
# 16, 24 and 48 to the next of 32, 64 and 128, the C_in the kernel is built
# for; C_in 128 takes 16-byte copies and the stride at run time, wgmma with
# 8 k16 steps per tap at stride 1 and mma.sync with one window at stride
# 2; C_out 32 and 40 a part-filled channel tile; batch 1 at 130 leaves a
# warpgroup with one tile fewer than its partner.
@pytest.mark.parametrize("c_in,c_out,stride,act,hw,batch,fill", [
    (32, 64, 1, "mish", 128, 2, "rand"), (32, 64, 2, "mish", 256, 2, "rand"),
    (64, 128, 2, "leaky", 304, 2, "rand"), (128, 128, 1, "linear", 130, 2, "rand"),
    (3, 32, 2, "leaky", 256, 2, "rand"), (64, 64, 1, "mish", 152, 2, "rand"),
    (32, 64, 1, "mish", (130, 136), 3, "rand"), (64, 64, 2, "leaky", (130, 268), 1, "rand"),
    (32, 64, 2, "mish", 608, 1, "rand"), (64, 128, 2, "mish", 304, 1, "rand"),
    (12, 64, 1, "relu", 136, 3, "rand"), (24, 40, 2, "mish", (140, 260), 1, "rand"),
    (16, 64, 1, "leaky", 130, 1, "rand"), (128, 128, 2, "mish", 256, 1, "rand"),
    (48, 64, 1, "mish", 136, 1, "rand"), (64, 64, 1, "linear", (130, 136), 1, "ones")])
def test_conv3x3_kernel_matches_plain(c_in, c_out, stride, act, hw, batch, fill):
    dev = _cuda()
    x, w, b = _operands(dev, batch, hw, c_in, c_out, torch.bfloat16, fill=fill)
    n0 = conv_mod.conv3x3_fused.launches
    got = conv_mod.conv3x3_fused(x, w, b, stride=stride, activation=act)
    torch.cuda.synchronize()
    assert conv_mod.conv3x3_fused.launches == n0 + 1
    ref = conv_mod.conv3x3_plain(x, w, b, stride=stride, activation=act)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _max_ulps(got, ref) <= 1.0
    if fill == "ones":
        _check_ones(got, c_in)


# The f32 contract: one instance per stride (the stride a template
# parameter), C_in 32, 64 and 128 as 1, 2 and 4 ring units a tile (C_in 128
# at stride 2 with a one-unit ring), on the main-path shapes, ragged tiles
# at both strides (H and W not multiples of the 4 x 16 tile: the TMA
# stores clip them), padded C_in, and C_out 8, 24 and 40 (a part-filled
# 32-channel output box, the second one skipped).
@pytest.mark.parametrize("c_in,c_out,stride,act,hw,batch,fill", [
    (32, 64, 2, "mish", 608, 1, "rand"), (32, 64, 1, "mish", 304, 2, "rand"),
    (64, 128, 2, "mish", 304, 1, "rand"), (64, 64, 1, "leaky", 152, 2, "rand"),
    (128, 128, 1, "linear", 130, 2, "rand"), (128, 64, 2, "mish", 256, 1, "rand"),
    (24, 40, 2, "relu", (140, 260), 1, "rand"), (64, 64, 1, "linear", (130, 136), 1, "ones"),
    (32, 64, 1, "mish", (130, 136), 3, "rand"), (64, 64, 2, "leaky", (130, 268), 1, "rand"),
    (128, 64, 2, "relu", (132, 260), 1, "rand"), (16, 24, 1, "mish", 136, 2, "rand"),
    (32, 8, 2, "linear", 256, 1, "rand"), (32, 64, 1, "linear", (132, 140), 2, "ones")])
def test_conv3x3_f32_kernel_matches_plain(c_in, c_out, stride, act, hw, batch, fill):
    dev = _cuda()
    x, w, b = _operands(dev, batch, hw, c_in, c_out, torch.float32, fill=fill)
    n0 = conv_mod.conv3x3_fused.launches
    got = conv_mod.conv3x3_fused(x, w, b, stride=stride, activation=act)
    torch.cuda.synchronize()
    assert conv_mod.conv3x3_fused.launches == n0 + 1
    ref = conv_mod.conv3x3_plain(x, w, b, stride=stride, activation=act)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    if fill == "ones":
        _check_ones(got, c_in)


def test_f32_forward_runs_without_tf32(monkeypatch):
    """An f32 Darknet on the card with the f32 route switched on
    (`conv3x3.F32_ENABLED`): its cuDNN convs see TF32 off (the caller's
    setting restored after), and its 3x3 layers launch the f32 kernel."""
    import torch.nn.functional as F

    from complex_yolov4_tpu_torch.models import network, weights, zoo

    dev = _cuda()
    monkeypatch.setattr(conv_mod, "F32_ENABLED", True)
    spec = zoo.get_model_spec("complex_yolov4")
    model = network.Darknet(spec, weights.from_folded(spec, weights.fold_batchnorm(
        spec, *weights.init_params_np(spec, 0))), compute_dtype=torch.float32, device=dev)
    seen = []
    real_conv2d = F.conv2d

    def conv2d(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real_conv2d(*args, **kw)

    monkeypatch.setattr(network.F, "conv2d", conv2d)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    n0 = conv_mod.conv3x3_fused.launches
    x = torch.rand(1, 3, 608, 608, device=dev)
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert seen and not any(a or b for a, b in seen)
    assert conv_mod.conv3x3_fused.launches - n0 == 5
    assert bool(torch.isfinite(out).all())
    # the whole f32 network against its all-plain run (the 3x3 layers through
    # conv3x3_plain, the same bf16 rounding, only the f32 summation order
    # differs): per column within 1e-3 of the column's scale, conf/cls within
    # 1e-3, as chip_smoke's f32 head check
    with torch.inference_mode():
        ref = model(x, kernels=False)
    diff = (out - ref).abs().amax(dim=(0, 1))
    assert float((diff / (ref.abs().amax(dim=(0, 1)) + 1e-6)).max()) <= 1e-3
    assert float(diff[6:].max()) <= 1e-3


def test_f32_default_forward_is_all_f32_sighted(monkeypatch):
    """complex_yolov4 at 608 on sighted weights (`sighted_params_np`: the
    input reaches the heads), f32: the default forward on the card (no
    kernel; every conv cuDNN f32, TF32 off) against the CPU's forward of the
    same model (all f32) within 1e-4 per column of the column's scale and
    on conf/cls. The 3x3 route's bf16 products (`conv3x3.F32_ENABLED`) move
    the same heads further than that, which is why the route is off by
    default."""
    from complex_yolov4_tpu_torch.models import network, sighted, weights, zoo

    dev = _cuda()
    spec = zoo.get_model_spec("complex_yolov4")
    rng = np.random.default_rng(0)
    params, state = sighted.sighted_params_np(
        spec, *weights.init_params_np(spec, 0),
        rng.uniform(0, 1, (1, 608, 608, 3)).astype(np.float32), device=dev)
    model = network.Darknet(spec, weights.from_jax_params(spec, params, state),
                            compute_dtype=torch.float32, device=dev)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 608, 608)).astype(np.float32))
    n0 = conv_mod.conv3x3_fused.launches
    with torch.inference_mode():
        out = model(x.to(dev)).cpu()
        ref = model.replicate(torch.device("cpu"))(x)
    assert conv_mod.conv3x3_fused.launches == n0

    def errs(got):
        diff = (got - ref).abs().amax(dim=(0, 1))
        return float((diff / (ref.abs().amax(dim=(0, 1)) + 1e-6)).max()), float(diff[6:].max())

    rel, prob = errs(out)
    assert rel <= 1e-4 and prob <= 1e-4, (rel, prob)
    monkeypatch.setattr(conv_mod, "F32_ENABLED", True)
    with torch.inference_mode():
        routed = model(x.to(dev)).cpu()
    assert conv_mod.conv3x3_fused.launches == n0 + 5
    assert max(errs(routed)) > 1e-4


def test_f32_train_step_runs_without_tf32(monkeypatch):
    """One f32 train step on the card: the forward's convs and the backward
    (read by a gradient hook on every parameter) see TF32 off, the caller's
    setting restored after; training launches no kernel."""
    import torch.nn.functional as F

    from complex_yolov4_tpu_torch import train as T
    from complex_yolov4_tpu_torch.models import network, weights, zoo

    dev = _cuda()
    spec = zoo.get_model_spec("complex_yolov4_tiny")
    model = network.TrainDarknet(spec, compute_dtype=torch.float32)
    model.load_state_dict(weights.to_train_state(spec, *weights.init_params_np(spec, 0)))
    model.to(dev)
    state = T.TrainState(model, T.create_optimizer(model))
    seen_fwd, seen_bwd = [], []
    real_conv2d = F.conv2d

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def conv2d(*args, **kw):
        seen_fwd.append(flags())
        return real_conv2d(*args, **kw)

    monkeypatch.setattr(network.F, "conv2d", conv2d)
    for p in model.parameters():
        p.register_hook(lambda g: seen_bwd.append(flags()))
    rng = np.random.default_rng(0)
    targets = np.zeros((2, 50, 7), np.float32)
    targets[:, :3] = [[0, 0.4, 0.5, 0.05, 0.1, 0.6, 0.8]]
    mask = np.zeros((2, 50), np.float32)
    mask[:, :3] = 1.0
    batch = {"image": rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32),
             "targets": targets, "target_mask": mask}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    n0 = conv_mod.conv3x3_fused.launches
    out = T.make_train_step()(state, batch, 1e-3, 0, False)
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert seen_fwd and not any(a or b for a, b in seen_fwd)
    assert len(seen_bwd) == len(list(model.parameters()))
    assert not any(a or b for a, b in seen_bwd)
    assert conv_mod.conv3x3_fused.launches == n0
    assert np.isfinite(float(out["loss"]))


def test_cuda_wrappers_raise_not_fall_back():
    dev = _cuda()
    x, w, b = _operands(dev, 1, 128, 32, 64, torch.float16)  # neither bf16 nor f32
    with pytest.raises(TypeError):
        conv_mod.conv3x3_fused(x, w, b, stride=1, activation="mish")
    with pytest.raises(ValueError):
        conv_mod.conv3x3_fused(x.to(torch.bfloat16), w.cpu(), b, stride=1, activation="mish")


def _segment_on(dev, name, span, seed=0):
    from complex_yolov4_tpu_torch.models import weights, zoo
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    spec = zoo.get_model_spec(name)
    params, state = weights.init_params_np(spec, seed)
    folded = weights.from_jax_params(spec, params, state)
    seg = next(s for s in fs.plan_segments(spec, 608) if (s.start, s.end) == span)
    return seg, fs.segment_weights(seg, {k: v.to(dev) for k, v in folded.items()})


@pytest.mark.parametrize("name,span,hw,batch", [
    pytest.param("complex_yolov4", (2, 10), 76, 2, id="complex_yolov4-span0-76"),
    pytest.param("complex_yolov4", (12, 23), 152, 2, id="complex_yolov4-span1-152"),
    pytest.param("complex_yolov4_tiny", (2, 8), 76, 2, id="complex_yolov4_tiny-span2-76"),
    pytest.param("complex_yolov3", (2, 4), 64, 2, id="complex_yolov3-span3-64"),
    pytest.param("complex_yolov3", (6, 11), 100, 2, id="complex_yolov3-span4-100"),
    pytest.param("complex_yolov4", (12, 23), 76, 2, id="complex_yolov4-12-23-76"),
    pytest.param("complex_yolov4", (2, 10), 76, 1, id="complex_yolov4-2-10-76-b1"),
    pytest.param("complex_yolov4", (12, 23), 76, 3, id="complex_yolov4-12-23-76-b3")])
def test_fused_stage_kernel_matches_plain(name, span, hw, batch):
    """Both round to bf16 after every op; another f32 summation order can
    flip one ulp that then runs through up to 12 ops: max |diff| <= 1e-2 *
    max |plain|. Widths 76, 100 and 152 leave ragged edge tiles."""
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    dev = _cuda()
    seg, sw = _segment_on(dev, name, span)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (batch, hw, hw, seg.cin))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    n0 = fs.apply_segment.launches
    got = fs.apply_segment(seg, x, sw)
    torch.cuda.synchronize()
    assert fs.apply_segment.launches == n0 + 1
    ref = fs.fused_stage_plain(seg, x, sw)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - ref.float()).abs().max()) <= 1e-2 * float(ref.float().abs().max())


# src: the input dtype, int8 (A by TMA: a box for 1x1 stride 1, im2col
# otherwise) or bf16 / f32 (quantized by the producer threads; 64 x 256
# tiles where C_out > 128). Every case also checks the f32 output mode.
@pytest.mark.parametrize("k,stride,c_in,c_out,hw,act,src,batch", [
    pytest.param(1, 1, 256, 128, 19, "mish", "int8", 2, id="1-1-256-128-19-mish"),
    pytest.param(3, 1, 256, 256, 20, "leaky", "int8", 2, id="3-1-256-256-20-leaky"),
    pytest.param(3, 2, 256, 512, 38, "mish", "int8", 2, id="3-2-256-512-38-mish"),
    pytest.param(1, 1, 1024, 512, 19, "linear", "int8", 2, id="1-1-1024-512-19-linear"),
    pytest.param(3, 1, 512, 1024, 19, "mish", "int8", 2, id="3-1-512-1024-19-mish"),
    pytest.param(1, 1, 1024, 1024, 19, "mish", "bf16", 8, id="1-1-1024-1024-19-bf16-b8"),
    pytest.param(3, 2, 256, 512, 38, "mish", "bf16", 2, id="3-2-256-512-38-bf16"),
    pytest.param(3, 2, 512, 1024, 38, "leaky", "bf16", 1, id="3-2-512-1024-38-bf16-b1"),
    pytest.param(1, 1, 512, 256, 38, "mish", "int8", 3, id="1-1-512-256-38-int8-b3"),
    pytest.param(3, 1, 256, 512, 38, "mish", "bf16", 3, id="3-1-256-512-38-bf16-b3"),
    pytest.param(1, 2, 256, 128, 22, "relu", "bf16", 1, id="1-2-256-128-22-bf16-b1"),
    pytest.param(3, 1, 256, 256, 19, "mish", "int8", 1, id="3-1-256-256-19-int8-b1"),
    pytest.param(3, 2, 256, 128, 19, "leaky", "int8", 3, id="3-2-256-128-19-int8-odd-b3"),
    pytest.param(1, 1, 256, 384, 19, "mish", "bf16", 2, id="1-1-256-384-19-bf16-wide-ragged"),
    pytest.param(1, 1, 512, 136, 19, "leaky", "bf16", 1, id="1-1-512-136-19-bf16-wide-8"),
    pytest.param(1, 1, 256, 128, 76, "mish", "f32", 2, id="1-1-256-128-76-f32"),
    pytest.param(1, 1, 512, 512, 19, "leaky", "f32", 3, id="1-1-512-512-19-f32-wide-b3"),
    pytest.param(3, 1, 256, 512, 38, "mish", "f32", 1, id="3-1-256-512-38-f32-wide"),
    pytest.param(3, 2, 256, 512, 38, "mish", "f32", 2, id="3-2-256-512-38-f32-wide"),
    pytest.param(3, 2, 512, 128, 19, "relu", "f32", 1, id="3-2-512-128-19-f32-odd"),
    pytest.param(1, 1, 256, 136, 19, "linear", "f32", 2, id="1-1-256-136-19-f32-wide-ragged"),
    pytest.param(1, 2, 256, 128, 22, "mish", "f32", 1, id="1-2-256-128-22-f32"),
    pytest.param(3, 1, 128, 64, 20, "leaky", "f32", 2, id="3-1-128-64-20-f32-c_out-64")])
def test_int8_kernel_matches_plain(k, stride, c_in, c_out, hw, act, src, batch):
    """int32 sums exactly equal (a bf16 or f32 input quantized in the kernel
    as by `quantize_input`); the f32 epilogue's activation uses the fast exp
    and divide, so bf16 within 1 ulp, requantized int8 within 1 and f32
    within 1e-5 of max |plain|."""
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    dev = _cuda()
    rng = np.random.default_rng(k * 7 + c_in)
    if src == "int8":
        x = torch.from_numpy(rng.integers(-127, 128, (batch, hw, hw, c_in)).astype(np.int8))
    else:  # N(0, 1) against a clip at +-3: a few values saturate
        x = torch.from_numpy(rng.normal(0, 1, (batch, hw, hw, c_in)).astype(np.float32))
        if src == "f32":  # a tenth of the values on exact half-steps (n + 1/2) s_x
            ties = torch.from_numpy(rng.random(x.shape) < 0.1)
            halves = torch.from_numpy(rng.integers(-130, 130, x.shape) + 0.5).float() * (3.0 / 127.0)
            x = torch.where(ties, halves, x)
        else:
            x = x.to(torch.bfloat16)
    x = x.to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (c_out, k * k * c_in)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, c_out).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 0.5, c_out).astype(np.float32)).to(dev)
    s_x = np.float32(3.0 / 127.0)
    kw = {"ksize": k, "stride": stride, "s_x": float(s_x), "activation": act,
          "inv_s_x": float(np.float32(1.0) / s_x)}
    n0 = i8.int8_conv.launches
    got32 = i8.int8_conv(x, w, scale, b, out="int32", **kw)
    got = i8.int8_conv(x, w, scale, b, **kw)
    got8 = i8.int8_conv(x, w, scale, b, out="int8", inv_s_next=31.0, **kw)
    got_f32 = i8.int8_conv(x, w, scale, b, out="f32", **kw)
    torch.cuda.synchronize()
    assert i8.int8_conv.launches == n0 + 4
    assert torch.equal(got32, i8.int8_conv_plain(x, w, scale, b, out="int32", **kw))
    assert _max_ulps(got, i8.int8_conv_plain(x, w, scale, b, **kw)) <= 1.0
    ref8 = i8.int8_conv_plain(x, w, scale, b, out="int8", inv_s_next=31.0, **kw)
    assert int((got8.int() - ref8.int()).abs().max()) <= 1
    ref_f32 = i8.int8_conv_plain(x, w, scale, b, out="f32", **kw)
    assert got_f32.dtype == torch.float32 and got_f32.shape == ref_f32.shape
    assert float((got_f32 - ref_f32).abs().max()) <= 1e-5 * float(ref_f32.abs().max())


def test_f32_int8_forward_never_quantizes_on_the_host(monkeypatch):
    """An f32 `--quantize int8` forward on the card hands each non-chained
    int8 conv its f32 activation (the kernel quantizes it): the plain
    `quantize_input` pass is never called. Heads against the all-plain run
    (which does call it) within chip_smoke's int8 path bounds, 2e-2 of each
    column's scale and 1e-2 on conf/cls: the f32 3x3 kernel sums in another
    order than its plain version (about 1e-6 relative), which moves an
    activation lying that close to a half-step by one int8 step."""
    from complex_yolov4_tpu_torch.models import network, quantize, weights, zoo
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    dev = _cuda()
    spec = zoo.get_model_spec("complex_yolov4_tiny")
    folded = weights.fold_batchnorm(spec, *weights.init_params_np(spec, 0))
    x = np.random.default_rng(1).uniform(0, 1, (2, 608, 608, 3)).astype(np.float32)
    act_max = quantize.calibrate(spec, folded, [x], device=dev, compute_dtype=torch.float32)
    tree = quantize.make_quant(spec, folded, act_max)
    model = network.Darknet(spec, weights.from_folded(spec, folded), compute_dtype=torch.float32,
                            device=dev, quant=weights.from_jax_quant(spec, tree))
    n_quant = sum(r == "int8" for r in model.routes(608).values())
    assert n_quant > 0

    def refuse(*args, **kw):
        raise AssertionError("quantize_input called on the card's int8 path")

    xs = torch.from_numpy(x).permute(0, 3, 1, 2).to(dev)
    with monkeypatch.context() as m:
        m.setattr(i8, "quantize_input", refuse)
        n0 = i8.int8_conv.launches
        with torch.inference_mode():
            out = model(xs)
        torch.cuda.synchronize()
        assert i8.int8_conv.launches - n0 == n_quant
    assert bool(torch.isfinite(out).all())
    with torch.inference_mode():
        ref = model(xs, kernels=False)
    diff = (out - ref).abs().amax(dim=(0, 1))
    assert float((diff / (ref.abs().amax(dim=(0, 1)) + 1e-6)).max()) <= 2e-2
    assert float(diff[6:].max()) <= 1e-2


def test_new_wrappers_raise_not_fall_back():
    from complex_yolov4_tpu_torch.ops import fused_stage as fs
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    dev = _cuda()
    seg, sw = _segment_on(torch.device("cpu"), "complex_yolov4", (2, 10))
    with pytest.raises(ValueError):  # weights on the CPU, x on the card
        fs.apply_segment(seg, torch.zeros((1, 64, 64, 64), dtype=torch.bfloat16, device=dev), sw)
    x = torch.zeros((1, 8, 8, 256), dtype=torch.int8, device=dev)
    w = torch.zeros((64, 256), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        i8.int8_conv(x, w, torch.ones(64), torch.zeros(64, device=dev), ksize=1, stride=1,
                     s_x=0.1, activation="mish")


@pytest.mark.parametrize("packed", [True, False])
def test_points_raster_on_card(packed):
    """The points raster on the card against the same function on the CPU:
    the JAX package's budget (fewer than 1e-4 cells one cell over, where the
    card divides by a reciprocal; the rest within 5e-5)."""
    from complex_yolov4_tpu_torch.data import bev, synthetic

    dev = _cuda()
    pads = [bev.pad_points(bev.remove_points_outside(
        synthetic.sample_scene(np.random.default_rng(s))[0]), 30_000) for s in (3, 11, 29)]
    pts = torch.from_numpy(np.stack([p for p, _ in pads]))
    msk = torch.from_numpy(np.stack([m for _, m in pads]))
    got = bev.make_bev_map_points(pts.to(dev), msk.to(dev), packed=packed).cpu().numpy()
    ref = bev.make_bev_map_points(pts, msk, packed=packed).numpy()
    mismatched = np.abs(got - ref).max(axis=-1) > 5e-5
    assert mismatched.mean() < 1e-4, f"{mismatched.sum()} cells differ"
    np.testing.assert_allclose(got[~mismatched], ref[~mismatched], atol=5e-5)


@pytest.mark.parametrize("flags", [(), ("--cells_raster",)], ids=["points", "cells"])
def test_evaluate_cli_on_card(flags, tmp_path, capsys):
    """The eval CLI on its default device, complex_yolov4_tiny in bf16: the
    kernels launch once per routed layer per batch, and the report prints."""
    from complex_yolov4_tpu_torch.cli import evaluate
    from complex_yolov4_tpu_torch.data import synthetic

    _cuda()
    root = synthetic.generate_kitti_dataset(str(tmp_path / "kitti"), num_train=0, num_val=4,
                                            num_test=0, seed=0)
    conv_mod.conv3x3_fused.launches = stem_mod.conv3x3_stem.launches = 0
    out, model = evaluate.main(["--dataset_dir", root, "--model", "complex_yolov4_tiny",
                                "--batch_size", "2", "--compute_dtype", "bfloat16", *flags])
    routes = list(model.routes(608).values())
    assert model.device.type == "cuda"
    assert conv_mod.conv3x3_fused.launches == 2 * routes.count("conv3x3") > 0
    assert stem_mod.conv3x3_stem.launches == 2 * routes.count("stem")
    assert f"mAP: {float(out['mAP']):.4f}" in capsys.readouterr().out


def test_evaluate_cli_f32_default_on_card(tmp_path, capsys, monkeypatch):
    """The eval CLI with no flags (the JAX CLI's default float32) on the
    card: no kernel launches (every conv cuDNN f32, as JAX's shipped
    executor) and the report prints; with `conv3x3.F32_ENABLED` the 3x3
    layers launch the f32 kernel once per batch each, and still no stem."""
    from complex_yolov4_tpu_torch.cli import evaluate
    from complex_yolov4_tpu_torch.data import synthetic

    _cuda()
    root = synthetic.generate_kitti_dataset(str(tmp_path / "kitti"), num_train=0, num_val=4,
                                            num_test=0, seed=0)
    argv = ["--dataset_dir", root, "--model", "complex_yolov4_tiny", "--batch_size", "2"]
    conv_mod.conv3x3_fused.launches = stem_mod.conv3x3_stem.launches = 0
    out, model = evaluate.main(argv)
    assert model.compute_dtype == torch.float32 and model.routes(608) == {}
    assert conv_mod.conv3x3_fused.launches == stem_mod.conv3x3_stem.launches == 0
    assert f"mAP: {float(out['mAP']):.4f}" in capsys.readouterr().out
    monkeypatch.setattr(conv_mod, "F32_ENABLED", True)
    out, model = evaluate.main(argv)
    routes = list(model.routes(608).values())
    assert "stem" not in routes
    assert conv_mod.conv3x3_fused.launches == 2 * routes.count("conv3x3") > 0
    assert stem_mod.conv3x3_stem.launches == 0
    assert f"mAP: {float(out['mAP']):.4f}" in capsys.readouterr().out


def test_train_cli_on_card(tmp_path):
    """The train CLI on its default device: complex_yolov4_tiny, bf16, two
    micro-batches of 2 into one optimizer step, f32 validation (all f32: no
    kernel launch), a checkpoint that the eval CLI loads."""
    import os

    from complex_yolov4_tpu_torch.cli import evaluate, train
    from complex_yolov4_tpu_torch.data import synthetic

    _cuda()
    root = synthetic.generate_kitti_dataset(str(tmp_path / "kitti"), num_train=4, num_val=2,
                                            num_test=0, seed=0)
    wd = str(tmp_path / "wd")
    conv_mod.conv3x3_fused.launches = 0
    timings = {}
    state = train.main(["--dataset_dir", root, "--model", "complex_yolov4_tiny",
                        "--batch_size", "2", "--subdivisions", "2", "--num_epochs", "1",
                        "--working_dir", wd, "--print_freq", "1"], timings=timings)
    assert state.global_step == 2 and state.device.type == "cuda"
    assert conv_mod.conv3x3_fused.launches == 0  # training and f32 validation run no kernel
    ckpt = os.path.join(wd, "checkpoints", "complexer_yolo", "epoch_1.ckpt")
    out, model = evaluate.main(["--dataset_dir", root, "--model", "complex_yolov4_tiny",
                                "--batch_size", "2", "--pretrained_path", ckpt])
    assert model.device.type == "cuda" and np.isfinite(float(out["mAP"]))


# Rotated NMS kernel (csrc/nms.cu) against `nms_batch_plain` on the card.
# The kernel repeats the plain IoU's f32 ops in order, but sums in index
# order where PyTorch's reductions need not: a pair whose plain IoU lies
# within 1e-5 of nms_thresh may decide the other way, so a frame holding
# such a pair of one class is not held to the plain keep mask; every other
# frame keeps the same rows, and the merged rows (conf-weighted f32 sums in
# another order) agree within 1e-5 relative (1e-6 absolute for im, re near
# 0). The heads are f32 with continuous scores: no two candidates tie.

def _check_nms(d, conf, thr, k):
    """Kernel against plain on the card; returns the kept rows a frame."""
    from complex_yolov4_tpu_torch.ops import nms as nms_mod

    got_rows, got_mask = nms_mod.nms_batch(d, conf, thr, k)
    want_rows, want_mask = nms_mod.nms_batch_plain(d, conf, thr, k)
    near = nms_near_threshold(d, conf, thr, min(k, d.shape[1]))
    assert got_rows.shape == want_rows.shape and got_mask.shape == want_mask.shape
    held = 0
    for f in range(d.shape[0]):
        if near[f] and not torch.equal(got_mask[f], want_mask[f]):
            continue
        held += 1
        assert torch.equal(got_mask[f], want_mask[f]), f
        torch.testing.assert_close(got_rows[f], want_rows[f], rtol=1e-5, atol=1e-6)
    assert held >= d.shape[0] - 1  # a borderline pair excuses a frame rarely
    return want_mask.sum(1).cpu()


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("k", [64, 128, 256])
def test_nms_kernel_matches_plain(k, batch):
    dev = _cuda()
    d = nms_heads(k + batch, batch, 6000).to(dev)
    kept = _check_nms(d, 0.5, 0.4, k)
    assert (kept > 5).all() and (kept < k).all()  # suppression happened


def test_nms_kernel_cases():
    """A frame with no candidate, one where the best box suppresses every
    other, a chain of boxes each suppressing the next (the plain fixpoint
    needs a round a kept link), and rows fewer than k."""
    dev = _cuda()
    d = nms_heads(1, 2, 3000)
    d[1, :, 6] *= 0.1  # frame 1: every conf below 0.5
    assert _check_nms(d.to(dev), 0.5, 0.5, 64).tolist()[1] == 0
    rng = np.random.default_rng(2)
    n = 300
    yaw = 0.3 + rng.normal(0, 0.01, n)
    crowd = np.stack([300 + rng.normal(0, 0.5, n), 200 + rng.normal(0, 0.5, n),
                      20 + rng.normal(0, 0.3, n), 40 + rng.normal(0, 0.3, n), np.sin(yaw),
                      np.cos(yaw), rng.uniform(0.6, 1.0, n), rng.uniform(0.5, 1.0, n)], -1)
    assert _check_nms(torch.from_numpy(crowd[None].astype(np.float32)).to(dev),
                      0.5, 0.5, 64).tolist() == [1]
    chain = [[3.0 * i, 0.0, 10.0, 10.0, 0.0, 1.0, 0.9 - 0.01 * i, 1.0] for i in range(40)]
    chain += [[500.0 + 50 * j, 500.0, 10.0, 10.0, 0.0, 1.0, 0.1, 1.0] for j in range(2)]
    assert _check_nms(torch.tensor([chain], device=dev), 0.5, 0.5, 64).tolist() == [20]
    _check_nms(nms_heads(3, 2, 40).to(dev), 0.3, 0.5, 64)


def test_nms_kernel_makes_no_host_sync():
    from complex_yolov4_tpu_torch.ops import nms as nms_mod

    dev = _cuda()
    d = nms_heads(4, 16, 22743).to(dev)
    nms_mod.nms_batch(d, 0.5, 0.5, 64)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows, mask = nms_mod.nms_batch(d, 0.5, 0.5, 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(mask.sum()) > 0


def test_nms_kernel_launches_and_refusals():
    from complex_yolov4_tpu_torch.ops import nms as nms_mod

    dev = _cuda()
    d = nms_heads(5, 2, 600).to(dev)
    n0 = nms_mod.nms_batch.launches
    nms_mod.nms_batch(d, 0.5, 0.5, 64)
    assert 1 <= nms_mod.nms_batch.launches - n0 <= 2
    with pytest.raises(ValueError, match="at most 256"):
        nms_mod.nms_batch(d, 0.5, 0.5, 257)
    with pytest.raises(ValueError):  # the kernel takes f32 heads only
        nms_mod.nms_batch(d.to(torch.bfloat16), 0.5, 0.5, 64)


def test_served_request_counts_one_nms_kernel():
    """complex_yolov4_tiny served on the card in a tracing recording: one
    `nms.kernel` a request, no `nms.rounds`."""
    from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
    from complex_yolov4_tpu_torch.models import network, weights, zoo
    from complex_yolov4_tpu_torch.utils import tracing

    dev = _cuda()
    spec = zoo.get_model_spec("complex_yolov4_tiny", width=128, height=128)
    model = network.Darknet(spec, weights.from_folded(spec, weights.fold_batchnorm(
        spec, *weights.init_params_np(spec, 0))), compute_dtype=torch.bfloat16, device=dev)
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=64, img_size=128)
    images = torch.rand(2, 128, 128, 3)
    with tracing.recording() as rec:
        for _ in range(3):
            infer(model, images)
    assert rec.counters == {r: {"nms.kernel": 1} for r in range(3)}
