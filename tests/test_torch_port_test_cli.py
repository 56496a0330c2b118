"""The port's test/demo CLI (`complex_yolov4_tpu_torch.cli.test`) and its
test loader, against the JAX package's, on the CPU.

- `create_test_loader` batches (points with the host image, and images
  only) equal the JAX loader's, bit for bit;
- `cli.test.main` on complex_yolov4_tiny, f32, `--device cpu`, gives per
  batch the detections of JAX's `make_inference_fn(from_points=True)` on
  the same numpy-seeded weights (BN folded, as the port serves) and the
  same frames: masks equal, live rows within 1e-4 (rows matched as sets:
  scores within ~1e-6 may leave top-k in swapped order). conf_thresh sits
  in a >= 1e-4 gap of the port's sorted confidences (`gap_threshold`), so
  that the two implementations cannot disagree on a candidate;
- `--save_test_output` writes one .jpg per frame, or one .avi, and
  `--save_3d` one .html viewer per frame;
- with cv2 blocked, `--save_test_output` and `--show_image` raise naming
  cv2 before the run starts, and `--save_3d` (numpy only) still runs.

Every run reads its own synthetic tree under pytest's tmp_path.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu.evaluation import evaluator as jev
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.cli import test as tcli
from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.data import loader as tloader
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

from tests._torch_port_util import gap_threshold

NAME = "complex_yolov4_tiny"
K = 256


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=0, num_val=0, num_test=3,
        seed=2)


def _argv(root, wd, *extra):
    return ["--dataset_dir", root, "--model", NAME, "--device", "cpu", "--compute_dtype",
            "float32", "--working_dir", str(wd), *extra]


@pytest.mark.parametrize("device_raster", [True, False], ids=["points", "image"])
def test_test_loader_batches_identical(root, device_raster):
    jl = jloader.create_test_loader(root, 2, device_raster=device_raster)
    tl = tloader.create_test_loader(root, 2, device_raster=device_raster)
    assert jl.prefetch == tl.prefetch == 0 and len(jl) == len(tl) == 2
    for jb, tb in zip(list(jl), list(tl)):
        assert set(jb) == set(tb) and "image" in tb and "targets" not in tb
        for k in jb:
            a, b = np.asarray(jb[k]), np.asarray(tb[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def _match_rows(got, ref, tol):
    """Each live row of `got` has one row of `ref` within `tol` (max abs
    over the row), and the pairing is one to one."""
    d = np.abs(got[:, None, :] - ref[None, :, :]).max(axis=-1)
    pair = d.argmin(axis=1)
    assert len(set(pair.tolist())) == len(pair)
    assert d[np.arange(len(pair)), pair].max() <= tol


def test_detections_match_jax(root, tmp_path):
    spec = zoo.get_model_spec(NAME)
    params, state = weights.init_params_np(spec, 0)  # what the CLI's init_or_load gives
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=torch.device("cpu"))
    batches = list(tloader.create_test_loader(root, 2, device_raster=True))
    keys = ("points", "point_mask", "flip", "holes", "hole_mask")
    with torch.inference_mode():
        conf = torch.cat([model(bev.images_from_deferred_batch(
            {k: torch.from_numpy(b[k]) for k in keys}, 608).permute(0, 3, 1, 2))[..., 6]
            for b in batches])
    conf_thresh = gap_threshold(conf.numpy(), K)

    results = tcli.main(_argv(root, tmp_path / "wd", "--batch_size", "2",
                              "--conf_thresh", repr(conf_thresh)))
    jspec = get_model_spec(NAME)
    jinfer = jev.make_inference_fn(jnet.fold_spec(jspec), conf_thresh=conf_thresh,
                                   nms_thresh=0.5, max_boxes=K, compute_dtype=jnp.float32,
                                   from_points=True, batch_pack=None)
    fparams = jnet.fold_batchnorm(jspec, params, state)
    assert len(results) == len(batches) == 2
    live = 0
    for (ids, dets, masks), batch in zip(results, batches):
        np.testing.assert_array_equal(ids, batch["sample_ids"])
        jd, jm = jinfer(fparams, {}, *(jnp.asarray(batch[k]) for k in keys))
        jd, jm = np.asarray(jd), np.asarray(jm)
        assert dets.shape == jd.shape == (len(ids), K, 9)
        np.testing.assert_array_equal(masks, jm)
        for i in range(len(ids)):
            on = masks[i] > 0.5
            live += int(on.sum())
            _match_rows(dets[i][on], jd[i][on], 1e-4)
    assert live >= 4


@pytest.mark.parametrize("fmt", ["image", "video"])
def test_save_test_output(root, tmp_path, fmt):
    pytest.importorskip("cv2")
    wd = tmp_path / "wd"
    tcli.main(_argv(root, wd, "--num_samples", "2", "--batch_size", "2", "--save_test_output",
                    "--output_format", fmt, "--save_3d"))
    files = sorted(os.listdir(wd / "results" / "complexer_yolo"))
    if fmt == "image":
        assert [f for f in files if f.endswith(".jpg")] == ["000000.jpg", "000001.jpg"]
    else:
        vids = [f for f in files if f.endswith(".avi")]
        assert vids == ["out_complexer_yolo.avi"]
        assert os.path.getsize(wd / "results" / "complexer_yolo" / vids[0]) > 10_000
    assert [f for f in files if f.endswith(".html")] == ["000000.html", "000001.html"]


@pytest.mark.parametrize("flags", [("--save_test_output",),
                                   ("--save_test_output", "--output_format", "video"),
                                   ("--show_image",)], ids=["image", "video", "show"])
def test_drawing_flags_need_cv2(root, tmp_path, monkeypatch, flags):
    monkeypatch.setitem(sys.modules, "cv2", None)
    wd = tmp_path / "wd"
    with pytest.raises(ImportError, match="cv2"):
        tcli.main(_argv(root, wd, "--num_samples", "1", *flags))
    assert not (wd / "results").exists()  # raised before the run


def test_save_3d_needs_no_cv2(root, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    wd = tmp_path / "wd"
    results = tcli.main(_argv(root, wd, "--num_samples", "1", "--save_3d"))
    assert len(results) == 1
    assert os.listdir(wd / "results" / "complexer_yolo") == ["000000.html"]
