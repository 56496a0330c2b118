"""The port's training CLI (`complex_yolov4_tpu_torch.cli.train`) on the CPU.

- a synthetic run of complex_yolov4_tiny with `--device cpu` (batch 2,
  subdivisions 2, f32 validation, an async checkpoint), then a resume for
  a second epoch that continues `global_step`, as
  tests/test_cli.py::test_train_cli_end_to_end runs the JAX CLI; the
  checkpoint loads through `cli.evaluate --pretrained_path` into the same
  folded weights as the trained module's;
- the default `cli.evaluate --device cpu` (f32 compute) runs;
- `--num_processes 2`, `--mosaic`, `--remat` and `--profile_steps` pass
  the flag check (their runs: test_torch_port_shard.py,
  test_torch_port_mosaic.py, test_torch_port_remat.py); the TPU-link
  knobs are accepted and logged as not ported;
- `--device cuda` raises without CUDA.
"""

import logging
import os

import numpy as np
import pytest
import torch

from complex_yolov4_tpu_torch.cli import evaluate, train
from complex_yolov4_tpu_torch.config.runtime import parse_train_config
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.models import weights
from tests._torch_port_util import capped_threads  # noqa: F401

NAME = "complex_yolov4_tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=4, num_val=2, num_test=0,
        seed=6)


def _argv(root, wd, *extra):
    return ["--dataset_dir", root, "--model", NAME, "--batch_size", "2", "--device", "cpu",
            "--working_dir", wd, "--checkpoint_freq", "1", "--print_freq", "1", *extra]


def test_train_cli_end_to_end(root, tmp_path, capsys):
    wd = str(tmp_path / "wd")
    timings = {}
    state = train.main(_argv(root, wd, "--num_epochs", "1", "--subdivisions", "2",
                             "--compute_dtype", "float32", "--conf_thresh", "0.3"),
                       timings=timings)
    assert state.global_step == 2 and len(timings["step"]) == 2
    assert len(timings["mAP"]) == 1 and np.isfinite(timings["mAP"][0])
    ckpt = os.path.join(wd, "checkpoints", "complexer_yolo", "epoch_1.ckpt")
    assert os.path.isfile(ckpt)
    log = open(os.path.join(wd, "logs", "complexer_yolo", "logger_complexer_yolo.txt")).read()
    assert "val mAP" in log and "checkpoint save for epoch 1" in log

    # resume for one more epoch: the step count continues
    state2 = train.main(_argv(root, wd, "--num_epochs", "2", "--subdivisions", "2",
                              "--compute_dtype", "float32", "--no_val",
                              "--resume_path", ckpt))
    assert state2.global_step == 4
    assert os.path.isfile(os.path.join(wd, "checkpoints", "complexer_yolo", "epoch_2.ckpt"))

    # the checkpoint serves through cli.evaluate --pretrained_path
    capsys.readouterr()
    out, model = evaluate.main(["--dataset_dir", root, "--model", NAME, "--device", "cpu",
                                "--batch_size", "2", "--pretrained_path", ckpt])
    assert "mAP:" in capsys.readouterr().out and np.isfinite(float(out["mAP"]))
    spec = state.model.spec
    folded = weights.from_jax_params(spec, *weights.from_train_state(spec,
                                                                     state.model.state_dict()))
    for key, v in folded.items():
        i = key.split(".")[0][len("layer"):]
        buf = getattr(model, ("w" if key.endswith("weight") else "b") + i)
        assert torch.equal(buf.float(), v.float()), key


def test_evaluate_cli_f32_default_on_cpu(root, capsys):
    out, model = evaluate.main(["--dataset_dir", root, "--model", NAME, "--device", "cpu",
                                "--batch_size", "2"])
    assert model.compute_dtype == torch.float32 and model.routes(608) == {}
    assert "mAP:" in capsys.readouterr().out and np.isfinite(float(out["mAP"]))


@pytest.mark.parametrize("flags,item", [
    (("--mosaic",), None), (("--num_processes", "2"), None),
    (("--remat",), None), (("--profile_steps", "2"), None)],
    ids=["mosaic", "ddp", "remat", "profile"])
def test_unported_flags_raise(root, tmp_path, flags, item):
    """The flags that raised before they were ported (the last of them
    `--num_processes > 1`, data parallel) pass the flag check; an `item`
    would name the ROADMAP item of a flag that still raises."""
    argv = _argv(root, str(tmp_path / "wd"), *flags)
    if item is not None:
        with pytest.raises(ValueError, match=f"ROADMAP.md §1 {item}"):
            train.main(argv)
        return
    train._check_flags(parse_train_config(argv), logging.getLogger(__name__))


def test_link_knobs_logged_as_not_ported(root, tmp_path):
    wd = str(tmp_path / "wd")
    train.main(_argv(root, wd, "--num_epochs", "1", "--subdivisions", "1", "--no_val",
                     "--compute_dtype", "float32", "--epoch_preload", "--sync_checkpoint",
                     "--num_samples", "2"))
    log = open(os.path.join(wd, "logs", "complexer_yolo", "logger_complexer_yolo.txt")).read()
    for flag in ("epoch_preload", "sync_checkpoint", "batch_pack"):
        assert f"--{flag}: " in log and "not ported" in log


def test_device_cuda_needs_cuda(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the error without one")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--dataset_dir", root, "--model", NAME, "--working_dir",
                    str(tmp_path / "wd")])
