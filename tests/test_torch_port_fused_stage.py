"""The port's fused CSP stage vs the JAX package's.

- Planner: the port's `plan_segments` (with its Hopper tile choice in place
  of the TPU's VMEM budget) finds the same segments as the JAX one.
- Plain version: `fused_stage_plain` (what `apply_segment` runs for a CPU
  tensor) against the Pallas kernel in interpret mode, plain layout, at
  width 76, batch 1. Both round every value to bf16 after every op; a
  1-ulp flip from another f32 summation order can propagate through up to
  12 ops, so the bound is max |diff| <= 1e-2 * max |JAX|.
- Kernel program: the int32 op table `build_program` hands the CUDA kernel,
  run by `_emulate`, a numpy/torch transcription of `csrc/fused_stage.cu`
  (windows, one-pixel border, aliased parts, out-of-image zeros, ragged
  edge tiles), must give the plain version's result. The kernel's
  arithmetic itself is held to the plain version on the card
  (tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu.models.zoo import MODEL_ZOO
from complex_yolov4_tpu.ops import fused_stage as jfs
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.ops import fused_stage as tfs

SEG_CASES = [("complex_yolov4", (2, 10)), ("complex_yolov4", (12, 23)),
             ("complex_yolov4_tiny", (2, 8)), ("complex_yolov3", (2, 4)),
             ("complex_yolov3", (6, 11))]


def _seg_tuple(s):
    return (s.start, s.end, s.halo, s.cin, s.cout,
            tuple(dataclasses.astuple(o) for o in s.ops))


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_plan_equals_jax_at_608(name):
    want = [_seg_tuple(s) for s in jfs.plan_segments(get_model_spec(name), 608)]
    got = [_seg_tuple(s) for s in tfs.plan_segments(zoo.get_model_spec(name), 608)]
    assert got == want


def test_plan_equals_jax_small_width(monkeypatch):
    monkeypatch.setattr(jfs, "_MIN_W", 32)
    monkeypatch.setattr(tfs, "_MIN_W", 32)
    want = [_seg_tuple(s) for s in jfs.plan_segments(get_model_spec("complex_yolov4"), 128)]
    got = [_seg_tuple(s) for s in tfs.plan_segments(zoo.get_model_spec("complex_yolov4"), 128)]
    assert got == want and [s[:2] for s in got] == [(2, 10), (12, 23)]


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_programs_fit_and_never_alias_live_inputs(name):
    """Every planned segment gets a window that fits one block's shared
    memory, and no op writes over a buffer it reads."""
    for seg in tfs.plan_segments(zoo.get_model_spec(name), 608):
        prog = tfs.pick_tile(seg.ops, seg.cin)
        assert prog.smem_bytes <= tfs.SMEM_LIMIT
        assert prog.win_w % 16 == 0 and prog.win_h > 2 * seg.halo
        px = (prog.win_h + 2) * (prog.win_w + 2)
        ints = prog.ints
        for r in range(ints[0]):
            row = ints[tfs.HEADER_INTS + r * tfs.ROW_INTS:][:tfs.ROW_INTS]
            out = (row[3], row[3] + px * row[2])
            for p in range(row[6]):
                off, ld, c = row[7 + 3 * p:10 + 3 * p]
                read = (off, off + (px - 1) * ld + c)
                assert read[1] <= out[0] or out[1] <= read[0]


def _folded(name, seed):
    spec = zoo.get_model_spec(name)
    params, state = weights.init_params_np(spec, seed)
    jspec = get_model_spec(name)
    return spec, jnet.fold_batchnorm(jspec, params, state)


def _segment(name, span, seed=0):
    spec, fparams = _folded(name, seed)
    seg = next(s for s in tfs.plan_segments(spec, 608) if (s.start, s.end) == span)
    jseg = next(s for s in jfs.plan_segments(get_model_spec(name), 608)
                if (s.start, s.end) == span)
    state = weights.from_folded(spec, {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
                                       for k, v in fparams.items()})
    return seg, jseg, fparams, tfs.segment_weights(seg, state)


def _emulate(seg, x, sw):
    """`csrc/fused_stage.cu` fused_stage_kernel, block by block, on the CPU:
    the same op table, window, shared-memory offsets and masks."""
    ints = sw.program.tolist()
    _, win_w, win_h, halo, in_off, cin, peak, n_out = ints[:8]
    ws, ty, tx = win_w + 2, win_h - 2 * halo, win_w - 2 * halo
    b_sz, h, w, _ = x.shape
    out = torch.zeros((b_sz, h, w, seg.cout))
    wf, bfl = sw.w_flat.float(), sw.b_flat
    rr, cc = torch.meshgrid(torch.arange(win_h), torch.arange(win_w), indexing="ij")
    acts = {v: k for k, v in tfs.ACT_CODES.items()}

    def idx(off, ld, c, dy=1, dx=1):  # (win_h, win_w, c) element indices
        sp = (rr + dy) * ws + cc + dx
        return off + sp[..., None] * ld + torch.arange(c)

    for n in range(b_sz):
        for by in range((h + ty - 1) // ty):
            for bx in range((w + tx - 1) // tx):
                gy, gx = by * ty - halo + rr, bx * tx - halo + cc
                inside = ((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w))[..., None]
                vals = torch.zeros(peak)
                src = x[n, gy.clamp(0, h - 1), gx.clamp(0, w - 1)].float()
                vals[idx(in_off, cin, cin)] = torch.where(inside, src, 0.0)
                for r in range(ints[0]):
                    row = ints[tfs.HEADER_INTS + r * tfs.ROW_INTS:][:tfs.ROW_INTS]
                    kind, a, cout, out_off, w_off, b_off, nparts = row[:7]
                    parts = [row[7 + 3 * p:10 + 3 * p] for p in range(nparts)]
                    if kind == tfs.KIND_CODES["shortcut"]:
                        s = vals[idx(parts[0][0], parts[0][1], cout)] + \
                            vals[idx(parts[1][0], parts[1][1], cout)]
                        v = tfs.seg_act(s.to(torch.bfloat16), acts[a]).float()
                    else:
                        c_tot = sum(c for _, _, c in parts)
                        taps = [(ky, kx) for ky in range(3) for kx in range(3)] \
                            if kind == tfs.KIND_CODES["conv3x3"] else [(1, 1)]
                        acc = torch.zeros((win_h, win_w, cout))
                        for t, (ky, kx) in enumerate(taps):
                            krow = t * c_tot
                            for off, ld, c in parts:
                                a_m = vals[idx(off, ld, c, ky, kx)]
                                w_m = wf[w_off + krow * cout:w_off + (krow + c) * cout]
                                acc += a_m @ w_m.reshape(c, cout)
                                krow += c
                        y = (acc + bfl[b_off:b_off + cout]).to(torch.bfloat16)
                        v = tfs.seg_act(y, acts[a]).float()
                    vals[idx(out_off, cout, cout)] = torch.where(inside, v, 0.0)
                oy, ox = slice(halo, halo + ty), slice(halo, halo + tx)
                res = torch.cat([vals[idx(ints[8 + 3 * q], ints[9 + 3 * q], ints[10 + 3 * q])]
                                 for q in range(n_out)], dim=-1)[oy, ox]
                y0, x0 = by * ty, bx * tx
                hh, ww = min(ty, h - y0), min(tx, w - x0)
                out[n, y0:y0 + hh, x0:x0 + ww] = res[:hh, :ww]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("name,span", SEG_CASES)
def test_plain_and_program_match_pallas(name, span):
    seg, jseg, fparams, sw = _segment(name, span)
    rng = np.random.default_rng(span[0] * 100 + len(name))
    x = np.asarray(jnp.asarray(rng.standard_normal((1, 76, 76, seg.cin)),
                               jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jfs.apply_segment(
        jseg, jnp.asarray(x, jnp.bfloat16), jfs.segment_params(jseg, fparams),
        width=76, interpret=True, layout="plain"), np.float32)
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16)
    got = tfs.apply_segment(seg, xt, sw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    bound = 1e-2 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= bound
    emulated = _emulate(seg, xt, sw)
    assert (emulated.float() - got.float()).abs().max().item() <= bound


def _edge_segment(bias):
    """1x1 (bias `bias`, linear) -> 3x3 of ones (bias 0, linear), 16 ch."""
    ops = (tfs.SegOp("conv1x1", (-1,), 1, "linear", 16, 16),
           tfs.SegOp("conv3x3", (0,), 2, "linear", 16, 16))
    seg = tfs.Segment(1, 2, ops, 1, 16, 16)
    state = {"layer1.weight": torch.zeros(16, 16, 1, 1),
             "layer1.bias": torch.full((16,), bias),
             "layer2.weight": torch.full((16, 16, 3, 3), 1.0 / 16),
             "layer2.bias": torch.zeros(16)}
    return seg, state


def test_bias_does_not_leak_into_3x3_padding():
    """The 1x1 turns a zero image into `bias` everywhere; the 3x3 of ones
    must then see zero padding, not act(bias), past the image edge: 4 taps
    in at a corner, 6 on an edge, 9 inside."""
    bias = 2.0
    seg, state = _edge_segment(bias)
    sw = tfs.segment_weights(seg, state)
    x = torch.zeros((1, 40, 40, 16), dtype=torch.bfloat16)
    for got in (tfs.apply_segment(seg, x, sw), _emulate(seg, x, sw)):
        g = got.float()[0, ..., 0]
        assert g[0, 0] == 4 * bias and g[39, 39] == 4 * bias
        assert g[0, 20] == 6 * bias and g[20, 0] == 6 * bias
        assert g[20, 20] == 9 * bias
    jops = tuple(jfs.SegOp(**dataclasses.asdict(o)) for o in seg.ops)
    jseg = jfs.Segment(seg.start, seg.end, jops, seg.halo, seg.cin, seg.cout)
    fp = {"layer1": {"w": np.zeros((1, 1, 16, 16), np.float32),
                     "b": np.full(16, bias, np.float32)},
          "layer2": {"w": np.full((3, 3, 16, 16), 1.0 / 16, np.float32),
                     "b": np.zeros(16, np.float32)}}
    want = np.asarray(jfs.apply_segment(jseg, jnp.zeros((1, 40, 40, 16), jnp.bfloat16),
                                        jfs.segment_params(jseg, fp), width=40,
                                        interpret=True, tile=8), np.float32)
    np.testing.assert_array_equal(tfs.apply_segment(seg, x, sw).float().numpy(), want)


def test_wrapper_rejects():
    seg, state = _edge_segment(1.0)
    sw = tfs.segment_weights(seg, state)
    with pytest.raises(TypeError):
        tfs.apply_segment(seg, torch.zeros((1, 40, 40, 16)), sw)  # f32
    with pytest.raises(ValueError):
        tfs.apply_segment(seg, torch.zeros((1, 40, 40, 32), dtype=torch.bfloat16), sw)
    with pytest.raises(ValueError):
        tfs.apply_segment(seg, torch.zeros((1, 40, 16, 40), dtype=torch.bfloat16)
                          .permute(0, 1, 3, 2), sw)  # not contiguous
