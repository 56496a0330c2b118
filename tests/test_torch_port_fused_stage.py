"""The port's fused CSP stage vs the JAX package's.

- Planner: the port's `plan_segments` (with its Hopper tile choice in place
  of the TPU's VMEM budget) finds the same segments as the JAX one.
- Plain version: `fused_stage_plain` (what `apply_segment` runs for a CPU
  tensor) against the Pallas kernel in interpret mode, plain layout, at
  width 76, batch 1. Both round every value to bf16 after every op; a
  1-ulp flip from another f32 summation order can propagate through up to
  12 ops, so the bound is max |diff| <= 1e-2 * max |JAX|.
- Kernel program: the int32 op table `build_program` hands the CUDA kernel,
  run by `_emulate`, a torch transcription of `csrc/fused_stage.cu`
  (windows, regions that shrink by one pixel per 3x3, swizzled chunks,
  aliased parts, weight slots loaded one conv ahead, out-of-image zeros,
  ragged edge tiles) over a shared memory that starts as NaN, so that any
  read of a value no op wrote shows, must give the plain version's result. The kernel's
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
from tests._torch_port_util import capped_threads  # noqa: F401

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


def _rows(ints):
    return [ints[tfs.HEADER_INTS + r * tfs.ROW_INTS:][:tfs.ROW_INTS] for r in range(ints[0])]


def _parts(row):
    return [row[tfs.PART_AT + 4 * p:tfs.PART_AT + 4 * p + 4] for p in range(row[6])]


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_programs_fit_and_never_alias_live_inputs(name):
    """Every planned segment gets a window that fits one block's shared
    memory; no op writes over a buffer it reads; every conv's weight slot
    lies past the values and apart from the next conv's, which loads while
    it computes."""
    for seg in tfs.plan_segments(zoo.get_model_spec(name), 608):
        prog = tfs.pick_tile(seg.ops, seg.cin)
        assert prog.smem_bytes <= tfs.SMEM_LIMIT
        assert prog.win_w > 2 * seg.halo and prog.win_h > 2 * seg.halo
        px = prog.win_h * prog.win_w
        ints = prog.ints
        vals_elems, rows = ints[6], _rows(ints)
        for row in rows:
            out = (row[3], row[3] + px * row[2])
            assert out[1] <= vals_elems
            for base, c_buf, _, _ in _parts(row):
                read = (base, base + px * c_buf)
                assert read[1] <= out[0] or out[1] <= read[0]
            if row[0] != tfs.KIND_CODES["shortcut"]:
                slot = (row[8], row[8] + row[9] * row[2])
                assert vals_elems <= slot[0] and 2 * slot[1] <= prog.smem_bytes
                if row[10] >= 0:
                    nxt = rows[row[10]]
                    assert slot[1] <= nxt[8] or nxt[8] + nxt[9] * nxt[2] <= slot[0]


def _folded(name, seed):
    spec = zoo.get_model_spec(name)
    params, state = weights.init_params_np(spec, seed)
    jspec = get_model_spec(name)
    return spec, jnet.fold_batchnorm(jspec, params, state)


@pytest.fixture(scope="module")
def folded():
    """`_folded(name, 0)` by model name, built once for the module: two
    segment cases share each of complex_yolov4 and complex_yolov3."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _folded(name, 0)
        return cache[name]

    return get


def _segment(name, span, spec_and_params):
    spec, fparams = spec_and_params
    seg = next(s for s in tfs.plan_segments(spec, 608) if (s.start, s.end) == span)
    jseg = next(s for s in jfs.plan_segments(get_model_spec(name), 608)
                if (s.start, s.end) == span)
    state = weights.from_folded(spec, {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
                                       for k, v in fparams.items()})
    return seg, jseg, fparams, tfs.segment_weights(seg, state)


def _swz(row, chunk, nch):
    """csrc/fused_stage.cu swz: the stored position of 16-byte chunk
    `chunk` of a row of `nch` chunks."""
    lg = min(3, (nch & -nch).bit_length() - 1)
    return chunk ^ ((row >> (3 - lg)) & ((1 << lg) - 1))


def _idx(base, c_buf, off, c, rows):
    """Shared-memory element indices (len(rows), c) of channels off..off+c
    of rows `rows` of a buffer of c_buf channels per row at `base`."""
    ch = off + torch.arange(c)
    r = rows[:, None]
    return base + r * c_buf + _swz(r, ch // 8, c_buf // 8) * 8 + ch % 8


def _emulate(seg, x, sw):
    """`csrc/fused_stage.cu` fused_stage_kernel, block by block, on the CPU:
    the same op table, window, regions, swizzled shared-memory offsets,
    weight slots and masks."""
    ints = sw.program.tolist()
    n_rows, win_w, win_h, halo, in_base, cin, _, n_out = ints[:8]
    out_parts = [ints[8 + 4 * q:12 + 4 * q] for q in range(n_out)]
    rows = _rows(ints)
    ty, tx = win_h - 2 * halo, win_w - 2 * halo
    b_sz, h, w, _ = x.shape
    out = torch.zeros((b_sz, h, w, seg.cout))
    wf, bfl = sw.w_flat.float(), sw.b_flat
    acts = {v: k for k, v in tfs.ACT_CODES.items()}

    def load_weights(smem, row):
        k = torch.arange(row[9])
        smem[_idx(row[8], row[2], 0, row[2], k)] = \
            wf[row[4]:row[4] + row[9] * row[2]].reshape(row[9], row[2])

    for n in range(b_sz):
        for by in range((h + ty - 1) // ty):
            for bx in range((w + tx - 1) // tx):
                gy0, gx0 = by * ty - halo, bx * tx - halo
                smem = torch.full((sw.layout.smem_bytes // 2,), float("nan"))

                def pixels(e):  # a region's window pixels and in-image mask
                    rr, cc = torch.meshgrid(torch.arange(halo - e, halo + ty + e),
                                            torch.arange(halo - e, halo + tx + e),
                                            indexing="ij")
                    rr, cc = rr.reshape(-1), cc.reshape(-1)
                    gy, gx = gy0 + rr, gx0 + cc
                    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                    return rr * win_w + cc, rr, cc, inside[:, None]

                p, rr, cc, inside = pixels(halo)
                src = x[n, (gy0 + rr).clamp(0, h - 1), (gx0 + cc).clamp(0, w - 1)].float()
                smem[_idx(in_base, cin, 0, cin, p)] = torch.where(inside, src, 0.0)
                load_weights(smem, rows[ints[24]])
                for row in rows:
                    kind, a, cout, out_base, _, b_off, _, e = row[:8]
                    parts = _parts(row)
                    p, _, _, inside = pixels(e)
                    if kind == tfs.KIND_CODES["shortcut"]:
                        s = smem[_idx(*parts[0], p)] + smem[_idx(*parts[1], p)]
                        v = tfs.seg_act(s.to(torch.bfloat16), acts[a]).float()
                    else:
                        if row[10] >= 0:  # lands while this conv computes
                            load_weights(smem, rows[row[10]])
                        c_tot = sum(pt[3] for pt in parts)
                        taps = [(ky, kx) for ky in range(3) for kx in range(3)] \
                            if kind == tfs.KIND_CODES["conv3x3"] else [(1, 1)]
                        acc = torch.zeros((len(p), cout))
                        for t, (ky, kx) in enumerate(taps):
                            krow = t * c_tot
                            pt_px = p + (ky - 1) * win_w + (kx - 1)
                            for base, c_buf, off, c in parts:
                                a_m = smem[_idx(base, c_buf, off, c, pt_px)]
                                w_m = smem[_idx(row[8], cout, 0, cout, krow + torch.arange(c))]
                                acc += a_m @ w_m
                                krow += c
                        y = (acc + bfl[b_off:b_off + cout]).to(torch.bfloat16)
                        v = tfs.seg_act(y, acts[a]).float()
                    smem[_idx(out_base, cout, 0, cout, p)] = torch.where(inside, v, 0.0)
                p, _, _, _ = pixels(0)
                res = torch.cat([smem[_idx(*pt, p)] for pt in out_parts], dim=-1)
                res = res.reshape(ty, tx, seg.cout)
                y0, x0 = by * ty, bx * tx
                hh, ww = min(ty, h - y0), min(tx, w - x0)
                out[n, y0:y0 + hh, x0:x0 + ww] = res[:hh, :ww]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("name,span", SEG_CASES)
def test_plain_and_program_match_pallas(name, span, folded):
    seg, jseg, fparams, sw = _segment(name, span, folded(name))
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
