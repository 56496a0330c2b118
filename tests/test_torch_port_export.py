"""The port's export path: custom ops, the traceable NMS, weight formats.

- Each hand kernel's `torch.library` op passes `torch.library.opcheck`
  (schema, autograd registration, fake tensor, AOT dispatch) on the CPU,
  and its fake implementation, on fake CUDA tensors, gives the output's
  shape and dtype without building a kernel.
- The NMS fixpoint on a rank-ordered chain of mutual overlaps, which
  needs about k/2 rounds: the port's eager `nms_batch` (a Python loop),
  the same function exported and loaded back (a `while_loop`), and the
  JAX package's `nms_batch` keep the same boxes (merged boxes within 1e-4
  px: f32, the merge sums in another order); `nms_single` likewise. The
  two loop forms, both run eagerly, are bit-equal.
- The darknet and ckpt formats round-trip; the `.weights` bytes equal the
  JAX exporter's for the same --pretrained_path; stablehlo, orbax and a
  missing CUDA device raise.

The `.pt2` serving artifacts are held to the eager path and to the JAX
package's StableHLO artifact in tests/test_torch_port_export_pt2.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from complex_yolov4_tpu.cli import export as jexport_cli
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.ops import nms as jnms
from complex_yolov4_tpu_torch.cli import common
from complex_yolov4_tpu_torch.cli import export as ex
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models import weights_io as wio
from complex_yolov4_tpu_torch.ops import _build
from complex_yolov4_tpu_torch.ops import conv3x3 as c3
from complex_yolov4_tpu_torch.ops import fused_stage as fs
from complex_yolov4_tpu_torch.ops import nms as tnms
from complex_yolov4_tpu_torch.ops import stem_conv as st
from tests._torch_port_util import capped_threads  # noqa: F401

CPU = torch.device("cpu")
TINY = "complex_yolov4_tiny"


def _rng_t(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dtype)


def _segment_operands(rng):
    """(seg, SegmentWeights, x) of complex_yolov4's first segment (2-10)
    with seeded weights, on an 8x8 input."""
    seg = fs.plan_segments(zoo.get_model_spec("complex_yolov4"), 608)[0]
    state = {}
    for o in seg.ops:
        if o.kind in ("conv1x1", "conv3x3"):
            k = 3 if o.kind == "conv3x3" else 1
            state[f"layer{o.layer_index}.weight"] = _rng_t(rng, (o.cout, o.cin, k, k), 0.05)
            state[f"layer{o.layer_index}.bias"] = _rng_t(rng, (o.cout,), 0.1)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, seg.cin)).astype(np.float32))
    return seg, fs.segment_weights(seg, state), x.to(torch.bfloat16)


def _op_cases():
    rng = np.random.default_rng(0)
    stem_w = c3.pack_weight(_rng_t(rng, (32, 3, 3, 3), 0.1))
    conv_w = c3.pack_weight(_rng_t(rng, (64, 32, 3, 3), 0.05))
    x_stem = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    x_conv = torch.from_numpy(rng.uniform(0, 1, (1, 2, 256, 32)).astype(np.float32))
    seg, sw, xs = _segment_operands(rng)
    lay = sw.layout
    return {
        "stem": (torch.ops.cyv4.stem_conv3x3.default,
                 (x_stem, stem_w, _rng_t(rng, (32,), 0.1), "mish"), (1, 8, 8, 32)),
        "conv3x3_bf16": (torch.ops.cyv4.conv3x3.default,
                         (x_conv.to(torch.bfloat16), conv_w, _rng_t(rng, (64,), 0.1), 2,
                          "leaky"), (1, 1, 128, 64)),
        "conv3x3_f32": (torch.ops.cyv4.conv3x3.default,
                        (x_conv, conv_w, _rng_t(rng, (64,), 0.1), 1, "mish"),
                        (1, 2, 256, 64)),
        "fused_stage": (torch.ops.cyv4.fused_stage.default,
                        (xs, sw.w_flat, sw.b_flat, sw.program, list(fs.segment_code(seg)),
                         [lay.win_h, lay.win_w, lay.halo, lay.smem_bytes]),
                        (1, 8, 8, seg.cout)),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_opcheck(name):
    op, args, _ = OP_CASES[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_fake_on_cuda_builds_nothing(name, monkeypatch):
    """Tracing for the card runs the fake implementation on fake CUDA
    tensors: the output's shape, dtype and device, and no build."""
    def refuse(*_a, **_k):
        raise AssertionError("the fake implementation reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    op, args, shape = OP_CASES[name]
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        y = op(*fake)
    assert tuple(y.shape) == shape and y.device.type == "cuda"
    x = args[0]
    assert y.dtype == (torch.bfloat16 if x.dtype == torch.float32 and name == "stem"
                       else x.dtype)


def test_fake_rejects_bad_operands():
    """A bad shape fails at trace time, in the fake implementation."""
    op, args, _ = OP_CASES["fused_stage"]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        x = mode.from_tensor(args[0][..., :16].contiguous())
        with pytest.raises(ValueError):
            op(x, *args[1:])
        x = mode.from_tensor(torch.zeros((1, 2, 100, 32)))
        with pytest.raises(ValueError, match="envelope"):
            torch.ops.cyv4.conv3x3(x, *OP_CASES["conv3x3_f32"][1][1:])


def test_wrappers_run_the_ops():
    """The wrappers are the ops: equal outputs, on the plain version here."""
    for name, fn in (("stem", lambda a: st.conv3x3_stem(*a[:3], activation=a[3])),
                     ("conv3x3_f32", lambda a: c3.conv3x3_fused(*a[:3], stride=a[3],
                                                                activation=a[4]))):
        op, args, _ = OP_CASES[name]
        assert torch.equal(fn(args), op(*args))
    rng = np.random.default_rng(0)
    seg, sw, x = _segment_operands(rng)
    assert torch.equal(fs.apply_segment(seg, x, sw), fs.fused_stage_plain(seg, x, sw))
    assert fs.decode_segment(fs.segment_code(seg)).ops == tuple(
        o.__class__(**{**o.__dict__, "layer_index": i}) for i, o in enumerate(seg.ops))


# ---------------------------------------------------------------- NMS ----

def _chain(b=2, n=80, c=3):
    """(B, N, 7+C) decoded rows: boxes 10 px wide every 3 px along x, scores
    falling along the chain, one class: each box overlaps its neighbours at
    IoU 7/13 and the next but one at 4/16, so greedy keeps every other box
    and the fixpoint resolves one pair a round."""
    d = np.zeros((b, n, 7 + c), np.float32)
    for i in range(b):
        d[i, :, 0] = 20.0 + 3.0 * np.arange(n) + i
        d[i, :, 1] = 50.0
        d[i, :, 2] = 10.0
        d[i, :, 3] = 10.0
        d[i, :, 4] = 0.0
        d[i, :, 5] = 1.0
        d[i, :, 6] = np.linspace(0.99, 0.6, n)
        d[i, :, 7] = 0.9
    return d


class _NMS(torch.nn.Module):
    def forward(self, decoded):
        return tnms.nms_batch(decoded, 0.5, 0.5, 64)


def test_nms_chain_eager_exported_jax(tmp_path):
    d = _chain()
    got = tnms.nms_batch(torch.from_numpy(d), 0.5, 0.5, 64)
    path = str(tmp_path / "nms.pt2")
    torch.export.save(torch.export.export(_NMS(), (torch.from_numpy(d),)), path)
    loaded = torch.export.load(path).module()(torch.from_numpy(d))
    want = jnms.nms_batch(jnp.asarray(d), 0.5, 0.5, 64)
    jd, jm = np.asarray(want[0]), np.asarray(want[1])
    assert jm.sum(1).tolist() == [32, 32]
    for dets, masks in (got, loaded):
        np.testing.assert_array_equal(masks.numpy(), jm)
        np.testing.assert_allclose(dets.numpy(), jd, rtol=0, atol=1e-4)
    assert torch.equal(got[0], loaded[0]) and torch.equal(got[1], loaded[1])
    one = tnms.nms_single(torch.from_numpy(d[1]), 0.5, 0.5, 64)
    jone = jnms.nms_single(jnp.asarray(d[1]), 0.5, 0.5, 64)
    np.testing.assert_array_equal(one[1].numpy(), np.asarray(jone[1]))
    np.testing.assert_allclose(one[0].numpy(), np.asarray(jone[0]), rtol=0, atol=1e-4)


def test_nms_loop_forms_agree(monkeypatch):
    """The `while_loop` the export traces, run eagerly, keeps the same set as
    the Python loop that eager serving runs, on the chain (about k/2
    rounds) and on random rows."""
    rng = np.random.default_rng(4)
    rand = rng.uniform(0, 1, (2, 96, 10)).astype(np.float32)
    rand[..., :2] *= 40.0
    rand[..., 2:4] = rand[..., 2:4] * 8.0 + 2.0
    for d in (_chain(), rand):
        plain = tnms.nms_batch(torch.from_numpy(d), 0.5, 0.5, 64)
        with monkeypatch.context() as m:
            m.setattr(torch.compiler, "is_exporting", lambda: True)
            looped = tnms.nms_batch(torch.from_numpy(d), 0.5, 0.5, 64)
        assert torch.equal(plain[0], looped[0]) and torch.equal(plain[1], looped[1])
    assert int(plain[1].sum()) > 0


def test_nms_export_keeps_the_loop():
    """The exported NMS holds one while_loop node and no host read."""
    ep = torch.export.export(_NMS(), (torch.from_numpy(_chain()),))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("while_loop") == 1
    assert not any(t.endswith((".item", "_local_scalar_dense.default")) for t in targets)


# --------------------------------------------------------- weight files ----

def test_weight_formats_round_trip(tmp_path):
    spec, jspec = zoo.get_model_spec(TINY), get_model_spec(TINY)
    params, state = weights.init_params_np(spec, 1)
    src = str(tmp_path / "src.weights")
    wio.save_darknet_weights(spec, params, state, src)
    ref_params, ref_state = common.load_weights(spec, src)
    base = ["--model", TINY, "--pretrained_path", src, "--device", "cpu"]
    ex.main(base + ["--format", "darknet", "--output", str(tmp_path / "t.weights")])
    ex.main(base + ["--format", "ckpt", "--output", str(tmp_path / "t.ckpt")])
    jexport_cli.main(["--model", TINY, "--pretrained_path", src, "--format", "darknet",
                      "--output", str(tmp_path / "j.weights")])
    assert (tmp_path / "t.weights").read_bytes() == (tmp_path / "j.weights").read_bytes()
    for name in ("t.weights", "t.ckpt"):
        p, s = common.load_weights(spec, str(tmp_path / name))
        for tree, ref in ((p, ref_params), (s, ref_state)):
            assert set(tree) == set(ref)
            for k in ref:
                for leaf in ref[k]:
                    np.testing.assert_array_equal(np.asarray(tree[k][leaf]),
                                                  np.asarray(ref[k][leaf]))
    assert jspec.name == spec.name


@pytest.mark.parametrize("fmt,counterpart", [("stablehlo", "pt2"), ("orbax", "ckpt")])
def test_jax_formats_name_the_counterpart(fmt, counterpart, tmp_path):
    with pytest.raises(ValueError, match=f"--format {counterpart}"):
        ex.main(["--model", TINY, "--format", fmt, "--output", str(tmp_path / "x"),
                 "--device", "cpu"])


def test_export_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ex.main(["--model", TINY, "--format", "darknet", "--output", str(tmp_path / "x")])


def test_orbax_directory_names_the_route(tmp_path):
    with pytest.raises(ValueError, match="--format darknet"):
        common.load_weights(zoo.get_model_spec(TINY), str(tmp_path))
