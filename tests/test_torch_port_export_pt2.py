"""The `.pt2` of `cli.export` against the eager path and JAX's artifact.

- The artifact loaded back equals the port's eager `make_inference_fn` bit
  for bit on the CPU: complex_yolov4_tiny at 128 with image and points
  input, through `cli.export.main`; and complex_yolov4's first stages
  (layers 0-23, its own widths) under a 1x1 head conv and its first yolo
  head, at 256 with ``FUSED_STAGE=1`` (the fused planner's width floor
  lowered to 32, as tests/test_torch_port_fused_stage.py does): layer 0
  on ``cyv4::stem_conv3x3``, layer 1 on ``cyv4::conv3x3``, layers 2-10 and
  12-23 on two ``cyv4::fused_stage`` nodes, also in a fresh process that
  imports only `complex_yolov4_tpu_torch.ops` (and cannot import the JAX
  package). The cut keeps the test small: the full network's 64M weights
  would take the artifact to 128 MB.
- The port's artifact against the JAX package's `export_stablehlo`
  artifact on the same weights and points, in bf16: equal keep counts and
  rows matched as sets within 2% of each column's scale (the bf16 bound of
  tests/test_torch_port_network_bf16.py; conf and class columns 2e-3),
  with conf_thresh in a confidence gap of at least 2e-3 of the JAX
  network's heads (the two packages' bf16 confidences differ by 1.2e-4
  there), at k=64.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.cli import export as jexport_cli
from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.cli import export as ex
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.spec import ConvSpec, NetSpec, YoloSpec
from complex_yolov4_tpu_torch.ops import fused_stage as fs

from tests._torch_port_util import capped_threads, child_env, gap_threshold  # noqa: F401

CPU = torch.device("cpu")
TINY = "complex_yolov4_tiny"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


def _points(b, max_points, seed):
    """(B, P, 4) padded cropped synthetic clouds and their (B, P) mask."""
    from complex_yolov4_tpu_torch.data import bev

    pts, masks = [], []
    for i in range(b):
        cloud = bev.remove_points_outside(
            synthetic.sample_scene(np.random.default_rng(seed + i))[0])
        p, m = bev.pad_points(cloud, max_points)
        pts.append(p)
        masks.append(m)
    return np.stack(pts), np.stack(masks)


def _eager(spec, params, state, size, inputs, from_points, conf=0.5):
    model = ex.serving_model(spec, params, state, CPU, size)
    infer = make_inference_fn(conf_thresh=conf, nms_thresh=0.5, max_boxes=16,
                              from_points=from_points, img_size=size)
    if from_points:
        b = inputs[0].shape[0]
        return infer(model, inputs[0], inputs[1], np.zeros((b,), np.float32),
                     np.zeros((b, 0, 5), np.float32), np.zeros((b, 0), np.float32))
    return infer(model, inputs[0])


@pytest.mark.parametrize("kind", ["image", "points"])
def test_pt2_equals_eager_tiny(kind, tmp_path):
    spec = zoo.get_model_spec(TINY)
    path = str(tmp_path / "model.pt2")
    ex.main(["--model", TINY, "--img_size", "128", "--batch", "2", "--max_boxes", "16",
             "--input", kind, "--max_points", "2048", "--output", path, "--device", "cpu"])
    if kind == "image":
        inputs = (np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32),)
    else:
        inputs = _points(2, 2048, 7)
    params, state = weights.init_params_np(spec, 0)
    want = _eager(spec, params, state, 128, inputs, kind == "points")
    with torch.no_grad():
        got = torch.export.load(path).module()(*map(torch.from_numpy, inputs))
    assert float(want[1].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pt2_matches_jax_stablehlo(tmp_path):
    """Points -> detections: the port's .pt2 against the JAX package's
    StableHLO artifact, bridged weights, bf16 (module docstring)."""
    from jax import export as jexport

    spec, jspec = zoo.get_model_spec(TINY), get_model_spec(TINY)
    params, state = weights.init_params_np(spec, 4)
    pts, pmask = _points(2, 2048, 11)
    fspec = jnet.fold_spec(jspec)
    fparams = jnet.cast_conv_params(jnet.fold_batchnorm(jspec, params, state))
    img = jbev.images_from_deferred_batch(
        {"points": jnp.asarray(pts), "point_mask": jnp.asarray(pmask),
         "flip": jnp.zeros((2,)), "holes": jnp.zeros((2, 0, 5)),
         "hole_mask": jnp.zeros((2, 0))}, 128)
    decoded, _ = jnet.apply(fspec, fparams, {}, img, compute_dtype=jnp.bfloat16,
                            use_pallas_conv=False)
    conf = gap_threshold(np.asarray(decoded, np.float32)[..., 6], 64, min_gap=2e-3)
    kw = dict(batch=2, img_size=128, conf_thresh=conf, nms_thresh=0.5, max_boxes=64,
              input_kind="points", max_points=2048)
    jpath, tpath = str(tmp_path / "m.shlo"), str(tmp_path / "m.pt2")
    jexport_cli.export_stablehlo(jspec, params, state, jpath, **kw)
    ex.export_pt2(spec, params, state, tpath, device=CPU, **kw)
    with open(jpath, "rb") as f:
        jd, jm = jexport.deserialize(f.read()).call(fparams, pts, pmask)
    jd, jm = np.asarray(jd), np.asarray(jm)
    with torch.no_grad():
        td, tm = (t.numpy() for t in
                  torch.export.load(tpath).module()(torch.from_numpy(pts),
                                                    torch.from_numpy(pmask)))
    assert jm.sum() >= 4
    np.testing.assert_array_equal(tm.sum(1), jm.sum(1))
    scale = np.abs(jd).max(axis=(0, 1)) + 1e-6
    tol = np.where(np.arange(9) >= 6, 2e-3, 2e-2 * scale)
    for b in range(2):
        j_rows, t_rows = jd[b][jm[b] > 0], td[b][tm[b] > 0]
        over = (np.abs(j_rows[:, None, :] - t_rows[None, :, :]) / tol).max(-1)
        match = over.argmin(1)
        assert len(set(match.tolist())) == len(j_rows)  # a bijection
        assert over[np.arange(len(j_rows)), match].max() <= 1.0


def _first_stages():
    """complex_yolov4's layers 0-23, then a 1x1 head conv and a yolo head
    with the network's first head's anchors at stride 4."""
    full = zoo.get_model_spec("complex_yolov4")
    yolo = next(layer for layer in full.layers if isinstance(layer, YoloSpec))
    head = ConvSpec(filters=yolo.num_anchors * (7 + yolo.num_classes), size=1,
                    batch_normalize=False, activation="linear")
    return NetSpec(layers=full.layers[:24] + (head, dataclasses.replace(yolo, stride=4)),
                   width=SIZE, height=SIZE, name="complex_yolov4_stages_0_23")


def test_pt2_fused_stage_equals_eager_and_loads_fresh(tmp_path, monkeypatch):
    monkeypatch.setattr(fs, "_MIN_W", 32)
    monkeypatch.setenv("FUSED_STAGE", "1")
    spec = _first_stages()
    params, state = weights.init_params_np(spec, 0)
    path = str(tmp_path / "model.pt2")
    ex.export_pt2(spec, params, state, path, device=CPU, batch=1,
                  img_size=SIZE, conf_thresh=0.3, nms_thresh=0.5, max_boxes=16)
    ep = torch.export.load(path)
    ops = [str(n.target) for n in ep.graph.nodes if str(n.target).startswith("cyv4.")]
    assert sorted(ops) == ["cyv4.conv3x3.default", "cyv4.fused_stage.default",
                           "cyv4.fused_stage.default", "cyv4.stem_conv3x3.default"]
    x = np.random.default_rng(2).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    want = _eager(spec, params, state, SIZE, (x,), False, conf=0.3)
    assert float(want[1].sum()) > 0
    with torch.no_grad():
        got = ep.module()(torch.from_numpy(x))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.save(tmp_path / "x.npy", x)
    code = ("import sys, numpy as np, torch\n"
            "import complex_yolov4_tpu_torch.ops\n"
            "sys.modules['complex_yolov4_tpu'] = None\n"
            f"d, m = torch.export.load({path!r}).module()("
            f"torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
            f"torch.save((d, m), {str(tmp_path / 'out.pt')!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=180,
                         env=child_env())
    assert out.returncode == 0, out.stderr[-3000:]
    d, m = torch.load(tmp_path / "out.pt")
    assert torch.equal(d, want[0]) and torch.equal(m, want[1])
