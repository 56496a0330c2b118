"""`cli.train`'s `--remat` and `--profile_steps` in the port, on the CPU.

- remat (`TrainDarknet.forward(remat=True)`, each conv with its BN and
  activation checkpointed): two Adam steps of complex_yolov4_tiny at 64 px,
  batch 2, from the same numpy-seeded weights, with and without it: in f32
  the losses, parameters (each leaf within 1e-4 of its max |.| and every
  element within the 2 lr an Adam step can move) and BN running statistics
  (within 1e-6; recomputation must not move them a second time) of the
  plain step; in bf16 the same, the losses within 1e-3 relative; and one
  f32 remat step against the JAX package's `make_train_step(remat=True)`
  (`jax.checkpoint` of the whole forward): the loss within 1e-4 relative,
  the BN running statistics within 1e-4 of their max;
- `cli.train --remat --profile_steps 1 --profile_start 1 --device cpu`
  runs, logs both, and leaves one `torch.profiler` trace of the traced
  step (`*.pt.trace.json`, with the step's convolutions in it) in
  `logs_dir`; a profiler window the run never reaches writes nothing.
No test here touches `jax.profiler`.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu import train as JT
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu_torch import train as T
from complex_yolov4_tpu_torch.cli import train as tcli
from complex_yolov4_tpu_torch.data import synthetic
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import TrainDarknet
from tests._torch_port_util import capped_threads  # noqa: F401

NAME, SIZE, LR = "complex_yolov4_tiny", 64, 1e-3


def _batch():
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32),
             "targets": np.zeros((2, 8, 7), np.float32),
             "target_mask": np.zeros((2, 8), np.float32)}
    for b in range(2):
        for t in range(3):
            yaw = rng.uniform(-np.pi, np.pi)
            batch["targets"][b, t] = [t, rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9),
                                      rng.uniform(0.05, 0.3), rng.uniform(0.05, 0.4),
                                      np.sin(yaw), np.cos(yaw)]
            batch["target_mask"][b, t] = 1
    return batch


def _state(spec, params, bn_state, dtype):
    model = TrainDarknet(spec, compute_dtype=dtype)
    model.load_state_dict(weights.to_train_state(spec, params, bn_state))
    return T.TrainState(model, T.create_optimizer(model))


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_step_matches_plain(dtype):
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, bn_state = weights.init_params_np(spec, 0)
    batch = _batch()
    runs = {}
    for remat in (False, True):
        state = _state(spec, params, bn_state, dtype)
        step = T.make_train_step(remat=remat)
        losses = [float(step(state, batch, LR)["loss"]) for _ in range(2)]
        runs[remat] = (losses, weights.from_train_state(spec, state.model.state_dict()))
    (l0, (p0, s0)), (l1, (p1, s1)) = runs[False], runs[True]
    rel = 1e-4 if dtype == torch.float32 else 1e-3
    for a, b in zip(l1, l0):
        assert a == pytest.approx(b, rel=rel)
    for key, entry in p0.items():
        for leaf, v in entry.items():
            _close(p1[key][leaf], v, 1e-4, f"{key}.{leaf}")
            assert np.abs(p1[key][leaf] - v).max() <= 2 * LR * (1 + 1e-3), f"{key}.{leaf}"
    for key, entry in s0.items():
        for leaf, v in entry.items():
            _close(s1[key][leaf], v, 1e-6, f"{key}.{leaf}")
            # the statistics moved, twice (one update per step)
            assert not np.array_equal(v, bn_state[key][leaf]), f"{key}.{leaf}"


def test_remat_step_matches_jax_remat():
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, bn_state = weights.init_params_np(spec, 0)
    batch = _batch()
    jspec = get_model_spec(NAME, width=SIZE, height=SIZE)
    jp, jb = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, bn_state)
    tx = JT.create_optimizer(jp)
    jstep = JT.make_train_step(jspec, tx, compute_dtype=jnp.float32, remat=True,
                               batch_pack=None)
    jstate, jmetrics = jstep(JT.TrainState.create(jp, jb, tx),
                             {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(LR))
    state = _state(spec, params, bn_state, torch.float32)
    metrics = T.make_train_step(remat=True)(state, batch, LR)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    _, new_bn = weights.from_train_state(spec, state.model.state_dict())
    for key, entry in new_bn.items():
        for leaf, v in entry.items():
            _close(v, jstate.bn_state[key][leaf], 1e-4, f"{key}.{leaf}")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=4, num_val=0, num_test=0,
        seed=6)


def _argv(root, wd, *extra):
    return ["--dataset_dir", root, "--model", NAME, "--batch_size", "2", "--device", "cpu",
            "--working_dir", str(wd), "--num_epochs", "1", "--subdivisions", "1",
            "--compute_dtype", "float32", "--no_val", "--print_freq", "1", *extra]


def test_train_cli_remat_and_profiler(root, tmp_path):
    wd = tmp_path / "wd"
    state = tcli.main(_argv(root, wd, "--remat", "--profile_steps", "1",
                            "--profile_start", "1"))
    assert state.global_step == 2
    logs = wd / "logs" / "complexer_yolo"
    log = (logs / "logger_complexer_yolo.txt").read_text()
    assert ", remat" in log and "profiler trace of 1 steps written" in log
    traces = glob.glob(str(logs / "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(logs)
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)


def test_profiler_window_never_reached(root, tmp_path):
    wd = tmp_path / "wd"
    tcli.main(_argv(root, wd, "--profile_steps", "1", "--profile_start", "5"))
    assert not glob.glob(str(wd / "logs" / "complexer_yolo" / "*.pt.trace.json"))
