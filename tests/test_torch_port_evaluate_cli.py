"""The port's evaluation CLI (`complex_yolov4_tpu_torch.cli.evaluate`) on
the CPU.

- points (the default), `--cells_raster` with a padded tail batch, and
  `--quantize int8 --compute_dtype bfloat16` run end to end with
  `--device cpu` and print the JAX CLI's report;
- `--quantize int8 --compute_dtype float32` serves (the int8 kernel's f32
  output); fused stages in f32, an orbax checkpoint directory and
  `--device cuda` without CUDA raise; an f32 `Darknet` on a CUDA device is
  no longer refused by the port (it routes its 3x3 layers to the f32
  kernel with TF32 off);
- a darknet `.weights` file written by the JAX package's
  `save_darknet_weights` loads into the same trees in both packages and
  gives the same per-class lines and mAP through `--pretrained_path` in
  both CLIs (conf_thresh in a >= 1e-4 gap of the port's confidences, so
  that the JAX CLI's unfolded f32 BN and the port's folded one cannot
  disagree on a candidate).

Every run reads its own synthetic tree under pytest's tmp_path.
"""

import numpy as np
import pytest
import torch

from complex_yolov4_tpu.cli.evaluate import main as jax_main
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import weights_io as jwio
from complex_yolov4_tpu_torch.cli.evaluate import main
from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.data.loader import create_val_loader
from complex_yolov4_tpu_torch.models import weights, weights_io, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

from tests._torch_port_util import gap_threshold

NAME = "complex_yolov4_tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=0, num_val=3,
        num_test=0, seed=2)


def _argv(root, *extra):
    return ["--dataset_dir", root, "--model", NAME, "--device", "cpu", *extra]


def _report(text):
    return [ln.strip() for ln in text.splitlines() if ">>>" in ln or ln.startswith("mAP:")]


@pytest.mark.parametrize("extra", [
    ("--num_samples", "3", "--batch_size", "2"),
    ("--num_samples", "1", "--batch_size", "2", "--cells_raster"),
    ("--num_samples", "2", "--batch_size", "2", "--quantize", "int8",
     "--compute_dtype", "bfloat16", "--calib_batches", "1"),
], ids=["points", "cells_tail", "int8"])
def test_cli_runs_on_cpu(root, extra, capsys):
    out, model = main(_argv(root, *extra))
    text = capsys.readouterr().out
    report = _report(text)
    assert report[-1] == f"mAP: {float(out['mAP']):.4f}"
    assert len(report) == len(out["ap_class"]) + 1 >= 2
    assert model.device.type == "cpu"
    if "int8" in extra:
        assert "PTQ int8" in text
        assert "int8" in model.routes(608).values()


def test_synthetic_tree_written_once(tmp_path, monkeypatch):
    """--synthetic: the tree is generated into the temp directory, whole,
    and found again by the next run."""
    import tempfile

    from complex_yolov4_tpu_torch.cli import common
    from complex_yolov4_tpu_torch.config.runtime import parse_eval_config

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    config = parse_eval_config(["--synthetic", "--synthetic_frames", "4"])
    root = common.resolve_dataset_dir(config)
    assert root == str(tmp_path / "synthetic_kitti_torch_4")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["synthetic_kitti_torch_4"]
    assert len(list((tmp_path / root / "training" / "velodyne").iterdir())) == 4 + 2
    assert common.resolve_dataset_dir(config) == root


def test_int8_f32_raises(root, capsys):
    """int8 with f32 compute serves as the JAX package does (`network.py:496`):
    calibrated in f32, the int8 convs write f32. What still raises is an f32
    network with fused stages, which run in bf16 only."""
    out, model = main(_argv(root, "--num_samples", "2", "--batch_size", "2", "--quantize",
                            "int8", "--compute_dtype", "float32", "--calib_batches", "1"))
    assert "PTQ int8" in capsys.readouterr().out and np.isfinite(float(out["mAP"]))
    assert model.compute_dtype == torch.float32
    assert "int8" in model.routes(608).values()
    assert {kw.get("out", "bf16") for kw in model._int8_kw.values()} <= {"f32", "int8"}
    spec = zoo.get_model_spec(NAME)
    state = weights.from_folded(spec, weights.fold_batchnorm(
        spec, *weights.init_params_np(spec, 0)))
    with pytest.raises(ValueError, match="bf16 compute only"):
        Darknet(spec, state, compute_dtype=torch.float32, device=torch.device("cpu"),
                fused_stages=True)


def test_f32_on_cuda_raises():
    """An f32 network on a CUDA device is no longer refused by the port: its
    routes at 608 are the 3x3 kernel's layers, with no stem, and its forward
    runs with TF32 off (`precision_scope`, restored after). Without a card,
    only torch's placement of the buffers on the absent device raises."""
    from complex_yolov4_tpu_torch.models.network import kernel_routes, precision_scope

    spec = zoo.get_model_spec(NAME)
    assert set(kernel_routes(spec, 608, torch.float32).values()) == {"conv3x3"}
    state = weights.from_folded(spec, weights.fold_batchnorm(
        spec, *weights.init_params_np(spec, 0)))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with precision_scope(torch.float32, torch.device("cuda")):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        Darknet(spec, state, compute_dtype=torch.float32, device=torch.device("cuda"))


def test_orbax_directory_raises(root, tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        main(_argv(root, "--num_samples", "1", "--pretrained_path", str(tmp_path)))


def test_device_cuda_needs_cuda(root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the error without one")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--dataset_dir", root, "--model", NAME, "--num_samples", "1"])


def test_darknet_weights_same_map_in_both_clis(root, tmp_path, capsys):
    spec = zoo.get_model_spec(NAME)
    params, state = weights.init_params_np(spec, seed=9)
    path = str(tmp_path / "tiny.weights")
    jwio.save_darknet_weights(get_model_spec(NAME), params, state, path)
    jp, js = jwio.load_darknet_weights(get_model_spec(NAME), path)
    tp, ts = weights_io.load_darknet_weights(spec, path)
    for a, b in ((jp, tp), (js, ts)):
        assert a.keys() == b.keys()
        for key in a:
            for k in a[key]:
                np.testing.assert_array_equal(a[key][k], b[key][k])

    # a conf_thresh in a gap of the port's confidences on these frames
    model = Darknet(spec, weights.from_jax_params(spec, tp, ts),
                    compute_dtype=torch.float32, device=torch.device("cpu"))
    confs = []
    for b in create_val_loader(root, 3, device_raster=True):
        img = bev.images_from_deferred_batch(
            {k: torch.from_numpy(b[k]) for k in
             ("points", "point_mask", "flip", "holes", "hole_mask")}, 608)
        with torch.inference_mode():
            confs.append(model(img.permute(0, 3, 1, 2))[..., 6].numpy())
    conf_thresh = gap_threshold(np.concatenate(confs), 256)

    argv = ["--dataset_dir", root, "--model", NAME, "--batch_size", "3",
            "--pretrained_path", path, "--conf_thresh", repr(conf_thresh)]
    capsys.readouterr()
    jax_main(argv)
    jreport = _report(capsys.readouterr().out)
    out, _ = main(argv + ["--device", "cpu"])
    treport = _report(capsys.readouterr().out)
    assert treport == jreport and len(treport) >= 2
