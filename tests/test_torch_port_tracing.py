"""The serving entry's spans and the NMS round counter (`utils/tracing.py`).

- Off (no recording open), a served call under a CPU `torch.profiler`
  opens no `cyv4.` range; on, every call is one request: a `serve` span
  with `raster`, `network` and `nms` inside it (one each per replica), one
  request id a call, and the profiler's `cyv4.` ranges are the recorded
  spans name for name and in nesting. The detections are bit-equal on and
  off. For images, points, flat cells and batched cells over two devices.
- `nms.rounds` is the number of rounds `_keep_set`'s loop ran, counted by
  a spy on the loop body, on chains of boxes that need several rounds.
- `cli.export`'s `ServingProgram` (which reaches `nms_batch`), and a
  module that opens spans and counts in its forward, exported inside a
  recording hold no profiler op, record nothing, and serve the eager
  outputs of the module outside a recording.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from complex_yolov4_tpu_torch.cli import export as ex
from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.ops import nms as nms_mod
from complex_yolov4_tpu_torch.utils import tracing

from tests._torch_port_util import capped_threads  # noqa: F401

CPU = torch.device("cpu")
NAME = "complex_yolov4_tiny"
SIZE = 128
FRAMES = 2
PATHS = ["images", "points", "cells", "cells_two_devices"]
LAYERS = ("raster", "network", "nms")


@pytest.fixture(scope="module")
def served():
    """A folded f32 complex_yolov4_tiny on the CPU, each path's infer
    function and inputs, and each path's detections served untraced."""
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, state = weights.init_params_np(spec, seed=3)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=CPU)
    clouds = [bev.remove_points_outside(synthetic.sample_scene(np.random.default_rng(40 + s))[0])
              for s in range(FRAMES)]
    pts, pmask = zip(*(bev.pad_points(c, 20480) for c in clouds))
    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
    cap = max(len(c) for c in cells_l)
    kw = dict(conf_thresh=0.5, nms_thresh=0.5, max_boxes=16, img_size=SIZE)
    images = np.random.default_rng(5).uniform(0, 1, (FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    cases = {
        "images": (make_inference_fn(**kw), (images,)),
        "points": (make_inference_fn(from_points=True, **kw),
                   (np.stack(pts), np.stack(pmask), np.zeros(FRAMES, np.float32),
                    np.zeros((FRAMES, 1, 5), np.float32), np.zeros((FRAMES, 1), np.float32))),
        "cells": (make_inference_fn(from_cells=True, **kw),
                  (*bev.pack_cells_flat(cells_l, keys_l, FRAMES * cap), FRAMES)),
        "cells_two_devices": (make_inference_fn(from_cells=True, devices=[CPU, CPU], **kw),
                              (*bev.pack_cells_batched(cells_l, keys_l, cap), FRAMES)),
    }
    untraced = {p: infer(model, *inputs) for p, (infer, inputs) in cases.items()}
    return model, cases, untraced


def _cyv4_ranges(prof):
    """[(name, nearest enclosing cyv4 range's name or None)] of the
    profiler's `cyv4.` host ranges, in start order."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(tracing.PREFIX):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(tracing.PREFIX):
            parent = parent.cpu_parent
        out.append((e.name[len(tracing.PREFIX):],
                    None if parent is None else parent.name[len(tracing.PREFIX):]))
    return out


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("path", PATHS)
def test_served_spans(served, path, on):
    model, cases, untraced = served
    infer, inputs = cases[path]
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with tracing.recording() as rec:
                outs = [infer(model, *inputs) for _ in range(calls)]
        else:
            outs = [infer(model, *inputs) for _ in range(calls)]
    for dets, masks in outs:
        assert torch.equal(dets, untraced[path][0]) and torch.equal(masks, untraced[path][1])
    assert float(untraced[path][1].sum()) > 0  # live detections
    ranges = _cyv4_ranges(prof)
    if not on:
        assert ranges == []
        assert tracing._active is None
        return
    replicas = 2 if path == "cells_two_devices" else 1
    spans = rec.spans
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["serve"] * calls
    assert sorted({s.request for s in roots}) == list(range(calls))
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.name == "serve" and s.name in LAYERS and s.request == p.request
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for r in range(calls):
        names = sorted(s.name for s in spans if s.request == r and s.parent >= 0)
        assert names == sorted(LAYERS * replicas)
    recorded = [(s.name, None if s.parent < 0 else spans[s.parent].name) for s in spans]
    assert ranges == recorded
    summary = rec.summary()
    assert summary["requests"] == calls
    assert summary["spans"]["serve"]["calls"] == calls
    assert summary["spans"]["nms"]["calls"] == calls * replicas
    assert summary["counters"]["nms.rounds"] >= 1


def _chain(n, spacing=3.0, side=10.0):
    """(1, n + 2, 8) decoded heads: n equal square boxes along x, each
    overlapping the next at IoU 7/13 > 0.5 and the one after at 1/4, in
    falling score order, plus two far boxes below the threshold. The
    greedy keeps every other box, and the fixpoint rounds resolve the
    chain a link at a time."""
    rows = [[spacing * i, 0.0, side, side, 0.0, 1.0, 0.9 - 0.01 * i, 1.0] for i in range(n)]
    rows += [[500.0 + 50 * j, 500.0, side, side, 0.0, 1.0, 0.1, 1.0] for j in range(2)]
    return torch.tensor([rows], dtype=torch.float32)


@pytest.mark.parametrize("n", [0, 1, 4, 9])
def test_nms_rounds_counted(n, monkeypatch):
    decoded = _chain(n)
    ran = []
    body = nms_mod._rounds

    def spy(*carry):
        ran.append(1)
        return body(*carry)

    monkeypatch.setattr(nms_mod, "_rounds", spy)
    with tracing.recording() as rec:
        with tracing.span("serve"):
            _, mask = nms_mod.nms_batch(decoded, 0.5, 0.5, 16)
    nms_mod.nms_batch(decoded, 0.5, 0.5, 16)  # off: the loop runs, nothing is counted
    assert int(mask.sum()) == (n + 1) // 2
    rounds = len(ran) // 2
    assert rounds == len(ran) - rounds
    assert rec.counters == {0: ({"nms.rounds": rounds} if rounds else {})}
    assert rounds == (n + 1) // 2  # a kept link a round


class _Spanned(torch.nn.Module):
    """A module whose forward opens a span and counts, as the serving
    entry does."""

    def forward(self, x):
        with tracing.span("serve"):
            with tracing.span("network"):
                tracing.count("nms.rounds")
                return x * 2 + 1, (x > 0.5).float()


def _exportable(kind):
    """(module, its input): `cli.export`'s ServingProgram of
    complex_yolov4_tiny at 128 (it reaches `nms_batch`), or `_Spanned`."""
    x = torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    if kind == "spanned":
        return _Spanned(), x
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, state = weights.init_params_np(spec, 0)
    model = ex.serving_model(spec, params, state, CPU, SIZE)
    return ex.ServingProgram(model, from_points=False, img_size=SIZE, conf_thresh=0.5,
                             nms_thresh=0.5, max_boxes=16).eval(), x


@pytest.mark.parametrize("kind", ["serving_program", "spanned"])
def test_export_inside_recording_holds_no_span(kind):
    prog, x = _exportable(kind)
    with torch.no_grad():
        want = prog(x)
        with tracing.recording() as rec:
            with tracing.span("export"):  # an open request the trace must not count into
                exported = torch.export.export(prog, (torch.zeros_like(x),))
            got = exported.module()(x)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert [s.name for s in rec.spans] == ["export"] and rec.counters == {0: {}}
    assert float(want[1].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
