"""When the serving entry replays a CUDA graph (`evaluation/evaluator.py`
`serves_from_graph`, `_RequestGraph`), on the CPU.

- The rule, a function of what a call observes: COO cells on one CUDA
  device with no recording open replay; two devices, an open
  `tracing.recording()`, images and points (`from_cells` false), a CPU
  device, and a call under `torch.compile` or `torch.export` run eager.
- A CPU model never captures: repeated calls of one key, flat or
  batched, count no capture and no replay, and their answers are those of
  the first call. The functions for images and points carry the same
  counters at zero.
- Each head's anchors are a buffer of the model on its device, outside
  the state dict, equal to the spec's.
- The graphs a function keeps are bounded: with the rule held true and a
  stand-in for `_RequestGraph` on the CPU, requests of many capacities
  leave at most `GRAPH_KEYS` keys and graphs alive, the least recently
  used key going first, and a key pushed out starts again eager.

The replay itself needs the card: `tests/test_torch_port_gpu.py`.
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.evaluation import evaluator
from complex_yolov4_tpu_torch.evaluation.evaluator import (GRAPH_KEYS, make_inference_fn,
                                                           serves_from_graph)
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.utils import tracing

from tests._torch_port_util import capped_threads  # noqa: F401

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)
NAME = "complex_yolov4_tiny"
SIZE = 128
FRAMES = 2


@pytest.fixture(scope="module")
def served():
    """A folded f32 complex_yolov4_tiny on the CPU and the COO of two
    frames in both layouts."""
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, state = weights.init_params_np(spec, seed=3)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=CPU)
    clouds = [bev.remove_points_outside(synthetic.sample_scene(np.random.default_rng(40 + s))[0])
              for s in range(FRAMES)]
    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
    cap = max(len(c) for c in cells_l)
    coo = {"flat": bev.pack_cells_flat(cells_l, keys_l, FRAMES * cap),
           "batched": bev.pack_cells_batched(cells_l, keys_l, cap)}
    coo["flat_at"] = lambda lanes: bev.pack_cells_flat(cells_l, keys_l, FRAMES * cap + lanes)
    return model, coo


@pytest.mark.parametrize("device,n_devices,from_cells,recording,compiling,want", [
    pytest.param(CUDA, 0, True, False, None, True, id="cuda-cells"),
    pytest.param(CUDA, 1, True, False, None, True, id="cuda-cells-one-device"),
    pytest.param(CUDA, 2, True, False, None, False, id="two-devices"),
    pytest.param(CUDA, 0, True, True, None, False, id="recording-open"),
    pytest.param(CUDA, 0, False, False, None, False, id="images-or-points"),
    pytest.param(CPU, 0, True, False, None, False, id="cpu"),
    pytest.param(CUDA, 0, True, False, "is_compiling", False, id="under-compile"),
    pytest.param(CUDA, 0, True, False, "is_exporting", False, id="under-export")])
def test_graph_rule(device, n_devices, from_cells, recording, compiling, want, monkeypatch):
    if compiling:
        monkeypatch.setattr(torch.compiler, compiling, lambda: True)
    if recording:
        with tracing.recording():
            assert serves_from_graph(device, n_devices, from_cells) is want
        assert tracing._active is None
    else:
        assert serves_from_graph(device, n_devices, from_cells) is want


@pytest.mark.parametrize("layout", ["flat", "batched"])
def test_cpu_model_never_captures(served, layout):
    model, coo = served
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=16, from_cells=True,
                              img_size=SIZE)
    first = infer(model, *coo[layout], FRAMES)
    assert float(first[1].sum()) > 0  # live detections
    for _ in range(3):
        dets, masks = infer(model, *coo[layout], FRAMES)
        assert torch.equal(dets, first[0]) and torch.equal(masks, first[1])
    assert (infer.captures, infer.replays) == (0, 0)


@pytest.mark.parametrize("from_points", [False, True], ids=["images", "points"])
def test_eager_functions_carry_zero_counters(from_points):
    infer = make_inference_fn(from_points=from_points)
    assert (infer.captures, infer.replays) == (0, 0)


def test_anchors_are_device_buffers(served):
    model, _ = served
    spec = model.spec
    for i in spec.yolo_indices:
        got = getattr(model, f"anchors{i}")
        assert got.device == CPU and got.dtype == torch.float32
        assert torch.equal(got, torch.tensor(spec.layers[i].anchors, dtype=torch.float32))
    assert not any(k.startswith("anchors") for k in model.state_dict())


def test_touch_keeps_the_most_recent_keys():
    keys = collections.OrderedDict()
    assert [evaluator._touch(keys, k) for k in (0, 1, 0)] == [False, False, True]
    for k in range(2, 2 + 3 * GRAPH_KEYS):
        evaluator._touch(keys, k)
        evaluator._touch(keys, 0)  # in use between every other key
        assert len(keys) <= GRAPH_KEYS
    assert 0 in keys and 1 not in keys
    assert list(keys)[-1] == 0


class _StandIn:
    """`_RequestGraph`'s interface on the CPU: its body run at capture and
    at every replay. `alive` holds the instances not yet freed."""

    alive: "weakref.WeakSet" = weakref.WeakSet()

    def __init__(self, body, inputs, device):
        self.body = body
        self.alive.add(self)
        self.outputs = body([torch.as_tensor(x) for x in inputs])

    def __call__(self, inputs, n):
        dets, masks = self.body([torch.as_tensor(x) for x in inputs])
        return dets[:n], masks[:n]


def test_graphs_are_bounded_across_capacities(served, monkeypatch):
    """Each capacity served twice captures a graph of its own; after more
    capacities than GRAPH_KEYS, at most GRAPH_KEYS graphs are alive. A key
    kept in use between the others keeps its graph and replays; one pushed
    out runs eager again on its next call, then captures anew."""
    model, coo = served
    monkeypatch.setattr(evaluator, "serves_from_graph", lambda *a, **k: True)
    monkeypatch.setattr(evaluator, "_RequestGraph", _StandIn)
    infer = make_inference_fn(conf_thresh=0.5, nms_thresh=0.5, max_boxes=16, from_cells=True,
                              img_size=SIZE)
    want = infer(model, *coo["flat"], FRAMES)  # the key in use: eager
    infer(model, *coo["flat"], FRAMES)  # its capture
    assert (infer.captures, infer.replays) == (1, 0)
    others = [coo["flat_at"](64 * (i + 1)) for i in range(GRAPH_KEYS + 2)]
    for i, req in enumerate(others):
        for _ in range(2):  # eager, then a capture of its own
            dets, masks = infer(model, *req, FRAMES)
            assert torch.equal(dets, want[0]) and torch.equal(masks, want[1])
        dets, masks = infer(model, *coo["flat"], FRAMES)
        assert torch.equal(dets, want[0]) and torch.equal(masks, want[1])
        assert (infer.captures, infer.replays) == (2 + i, 1 + i)
        gc.collect()
        assert len(_StandIn.alive) <= GRAPH_KEYS
    # the oldest capacity went: its next call is eager, the one after captures
    infer(model, *others[0], FRAMES)
    assert (infer.captures, infer.replays) == (1 + len(others), len(others))
    infer(model, *others[0], FRAMES)
    assert infer.captures == 2 + len(others)
    del infer
    gc.collect()
    assert len(_StandIn.alive) == 0  # dropping the function frees its graphs
