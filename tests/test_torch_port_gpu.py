"""Port CUDA kernels on the card vs their plain PyTorch versions.

Marked `gpu`: each test skips without a CUDA device (decided inside the
test, so every worker collects the same tests). Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_port_gpu.py

(`--noconftest`: the repo's conftest imports JAX, which the GPU host lacks;
this file imports only torch and the port.) Conv kernel and plain version
see the same bf16 operands and both accumulate in f32, so they agree to one
bf16 ulp; values below 2^-10 of the tensor's largest, where the sum
cancels, are held to the ulp of that floor. The fused-stage and int8
tests state their own bounds.
"""

import numpy as np
import pytest
import torch

from complex_yolov4_tpu_torch.ops import conv3x3 as conv_mod
from complex_yolov4_tpu_torch.ops import stem_conv as stem_mod

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


def _operands(dev, b, hw, c_in, c_out, x_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (b, hw, hw, c_in)).astype(np.float32)
    bound = float(np.sqrt(1.0 / (9 * c_in)))
    w = rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c_out).astype(np.float32)
    return (torch.from_numpy(x).to(dev, x_dtype), conv_mod.pack_weight(torch.from_numpy(w)).to(dev),
            torch.from_numpy(bias).to(dev))


@pytest.mark.parametrize("c_in,c_out,act,hw", [
    (3, 32, "mish", 128), (6, 64, "leaky", 136), (12, 128, "linear", 64), (14, 128, "relu", 40)])
def test_stem_kernel_matches_plain(c_in, c_out, act, hw):
    dev = _cuda()
    x, w, b = _operands(dev, 2, hw, c_in, c_out, torch.float32)
    n0 = stem_mod.conv3x3_stem.launches
    got = stem_mod.conv3x3_stem(x, w, b, activation=act)
    torch.cuda.synchronize()
    assert stem_mod.conv3x3_stem.launches == n0 + 1
    ref = stem_mod.stem_plain(x, w, b, activation=act)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _max_ulps(got, ref) <= 1.0


@pytest.mark.parametrize("c_in,c_out,stride,act,hw", [
    (32, 64, 1, "mish", 128), (32, 64, 2, "mish", 256), (64, 128, 2, "leaky", 304),
    (128, 128, 1, "linear", 130), (3, 32, 2, "leaky", 256), (64, 64, 1, "mish", 152)])
def test_conv3x3_kernel_matches_plain(c_in, c_out, stride, act, hw):
    dev = _cuda()
    x, w, b = _operands(dev, 2, hw, c_in, c_out, torch.bfloat16)
    n0 = conv_mod.conv3x3_fused.launches
    got = conv_mod.conv3x3_fused(x, w, b, stride=stride, activation=act)
    torch.cuda.synchronize()
    assert conv_mod.conv3x3_fused.launches == n0 + 1
    ref = conv_mod.conv3x3_plain(x, w, b, stride=stride, activation=act)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _max_ulps(got, ref) <= 1.0


def test_cuda_wrappers_raise_not_fall_back():
    dev = _cuda()
    x, w, b = _operands(dev, 1, 128, 32, 64, torch.float32)  # f32 x: wrong for conv3x3
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


@pytest.mark.parametrize("name,span,hw", [
    ("complex_yolov4", (2, 10), 76), ("complex_yolov4", (12, 23), 152),
    ("complex_yolov4_tiny", (2, 8), 76), ("complex_yolov3", (2, 4), 64),
    ("complex_yolov3", (6, 11), 100)])
def test_fused_stage_kernel_matches_plain(name, span, hw):
    """Both round to bf16 after every op; another f32 summation order can
    flip one ulp that then runs through up to 12 ops: max |diff| <= 1e-2 *
    max |plain|. Widths 76, 100 and 152 leave ragged edge tiles."""
    from complex_yolov4_tpu_torch.ops import fused_stage as fs

    dev = _cuda()
    seg, sw = _segment_on(dev, name, span)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, hw, hw, seg.cin))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    n0 = fs.apply_segment.launches
    got = fs.apply_segment(seg, x, sw)
    torch.cuda.synchronize()
    assert fs.apply_segment.launches == n0 + 1
    ref = fs.fused_stage_plain(seg, x, sw)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - ref.float()).abs().max()) <= 1e-2 * float(ref.float().abs().max())


@pytest.mark.parametrize("k,stride,c_in,c_out,hw,act", [
    (1, 1, 256, 128, 19, "mish"), (3, 1, 256, 256, 20, "leaky"), (3, 2, 256, 512, 38, "mish"),
    (1, 1, 1024, 512, 19, "linear"), (3, 1, 512, 1024, 19, "mish")])
def test_int8_kernel_matches_plain(k, stride, c_in, c_out, hw, act):
    """int32 sums exactly equal; the f32 epilogue uses the same separate
    roundings, so bf16 within 1 ulp and requantized int8 within 1."""
    from complex_yolov4_tpu_torch.ops import int8_conv as i8

    dev = _cuda()
    rng = np.random.default_rng(k * 7 + c_in)
    x = torch.from_numpy(rng.integers(-127, 128, (2, hw, hw, c_in)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (c_out, k * k * c_in)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, c_out).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 0.5, c_out).astype(np.float32)).to(dev)
    kw = {"ksize": k, "stride": stride, "s_x": 0.0123, "activation": act}
    n0 = i8.int8_conv.launches
    got32 = i8.int8_conv(x, w, scale, b, out="int32", **kw)
    got = i8.int8_conv(x, w, scale, b, **kw)
    got8 = i8.int8_conv(x, w, scale, b, out="int8", inv_s_next=31.0, **kw)
    torch.cuda.synchronize()
    assert i8.int8_conv.launches == n0 + 3
    assert torch.equal(got32, i8.int8_conv_plain(x, w, scale, b, out="int32", **kw))
    assert _max_ulps(got, i8.int8_conv_plain(x, w, scale, b, **kw)) <= 1.0
    ref8 = i8.int8_conv_plain(x, w, scale, b, out="int8", inv_s_next=31.0, **kw)
    assert int((got8.int() - ref8.int()).abs().max()) <= 1


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
