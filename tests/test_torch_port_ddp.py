"""The port's data-parallel train step (2 gloo processes) against its
1-process step on the concatenated batch and against the JAX step on a
2-device data mesh, on the CPU.

complex_yolov4_tiny at 64 px, f32, SGD (Nesterov, momentum 0.949, weight
decay 5e-4), one optimizer step from the same numpy-seeded weights
(`weights.init_params_np` -> `to_train_state` for the port; the same trees
for JAX). Two ranks of batch 2 each (`tests/_torch_port_ddp_worker.py`,
launched as tests/test_multiprocess.py launches its workers, each wait
bounded and the workers killed when it runs out) against:

- the port's 1-process step on the batch of 4, rank 0's frames first;
- the JAX step on `make_mesh(jax.devices()[:2])` with the batch sharded over
  it, as tests/test_train.py::test_train_step_on_data_mesh runs it.

Held: the reported loss of every micro-batch within 1e-4 relative (the
1-process port also each of the 54 head metrics, within 1e-4 relative or
1e-6 absolute: they are the global batch's), the parameters within 5e-4
absolute (JAX's own mesh bound) and their step (new - old) within 1e-3 of
its largest |.| per leaf, the running BN mean and var within 1e-4 of their
largest |.| per leaf, and the two ranks' states bit-equal. Cases: MSE,
GIoU, `subdivisions 2` (two micro-batches per optimizer step, the first
under DDP's `no_sync`), `remat`, and unequal object counts per rank (rank
1 holds none), where per-rank means would differ from the global ones.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu import train as JT
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.parallel import make_mesh, replicate_tree, shard_batch
from complex_yolov4_tpu_torch import train as T
from complex_yolov4_tpu_torch.models import weights, zoo

from . import _torch_port_ddp_worker as W
from ._torch_port_util import (capped_threads, free_port, start_workers,  # noqa: F401
                               wait_workers)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results of the two gloo ranks: {case: [rank 0, rank 1]}.
    While the ranks run, this process runs every case's JAX mesh step
    (`_jax_mesh` keeps them)."""
    out = str(tmp_path_factory.mktemp("ddp"))
    port = free_port()
    procs = start_workers([os.path.join(_REPO, "tests", "_torch_port_ddp_worker.py")],
                          lambda r: [str(port), str(r), "2", out])
    try:
        # one thread a configuration: XLA compiles without the GIL
        with ThreadPoolExecutor(len(_CONFIGS)) as pool:
            list(pool.map(_compile, _CONFIGS))
        for case in W.CASES:
            _jax_mesh(case)
    finally:
        wait_workers(procs)
    return {case: [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False)
                   for r in range(2)]
            for case in W.CASES}


def _port_one_process(case):
    use_giou, subdivisions, remat, _ = W.CASES[case]
    spec = zoo.get_model_spec(W.NAME, width=W.SIZE, height=W.SIZE)
    state = W.fresh_state(spec)
    step = T.make_train_step(use_giou_loss=use_giou, subdivisions=subdivisions, remat=remat)
    metrics = [{k: float(v) for k, v in step(state, b, W.LR).items()}
               for b in W.global_batches(case)]
    return metrics, state.model.state_dict()


@functools.lru_cache(maxsize=None)
def _jax_step(use_giou, subdivisions, remat):
    """(mesh, optimizer, jitted step) of one configuration on a 2-device
    mesh, built once for the cases that share it."""
    spec = zoo.get_model_spec(W.NAME, width=W.SIZE, height=W.SIZE)
    params, _ = weights.init_params_np(spec, 0)
    jspec = get_model_spec(W.NAME, width=W.SIZE, height=W.SIZE)
    mesh = make_mesh(jax.devices()[:2])
    tx = JT.create_optimizer(jax.tree.map(jnp.asarray, params), optimizer_type="sgd",
                             subdivisions=subdivisions)
    step = JT.make_train_step(jspec, tx, use_giou_loss=use_giou, compute_dtype=jnp.float32,
                              mesh=mesh, remat=remat, batch_pack=None)
    return mesh, tx, step


# the (use_giou, subdivisions, remat) configurations of the cases
_CONFIGS = sorted({v[:3] for v in W.CASES.values()})


def _jax_state(mesh, tx):
    spec = zoo.get_model_spec(W.NAME, width=W.SIZE, height=W.SIZE)
    params, bn_state = weights.init_params_np(spec, 0)
    jp = jax.tree.map(jnp.asarray, params)
    return replicate_tree(mesh, JT.TrainState.create(jp, jax.tree.map(jnp.asarray, bn_state),
                                                     tx))


def _compile(config):
    """Compile one configuration's JAX mesh step ahead of `_jax_mesh` (the
    jitted step then finds it compiled)."""
    mesh, tx, step = _jax_step(*config)
    case = next(c for c, v in W.CASES.items() if v[:3] == config)
    step.lower(_jax_state(mesh, tx), shard_batch(mesh, W.global_batches(case)[0]),
               jnp.float32(W.LR)).compile()


@functools.lru_cache(maxsize=None)
def _jax_mesh(case):
    """(losses, params, bn_state) of the JAX step on a 2-device mesh."""
    use_giou, subdivisions, remat, _ = W.CASES[case]
    mesh, tx, step = _jax_step(use_giou, subdivisions, remat)
    state = _jax_state(mesh, tx)
    losses = []
    for b in W.global_batches(case):
        state, m = step(state, shard_batch(mesh, b), jnp.float32(W.LR))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params), jax.device_get(state.bn_state)


def _check_state(got, ref, init, what):
    """got/ref/init: {name: numpy} port-layout state dicts."""
    for k, r in ref.items():
        g = got[k]
        if k.endswith((".mean", ".var")):
            err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-12)
            assert err <= 1e-4, (what, k, err)
            continue
        assert np.abs(g - r).max() <= 5e-4, (what, k)
        d_ref, d = r - init[k], g - init[k]
        err = np.abs(d - d_ref).max() / max(np.abs(d_ref).max(), 1e-12)
        assert err <= 1e-3, (what, "step of", k, err)


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("case", list(W.CASES))
def test_two_rank_step_matches_one_process_and_jax_mesh(ranks, case):
    r0, r1 = ranks[case]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), ("ranks differ", k)
    assert r0["metrics"] == r1["metrics"] and r0["global_step"] == r1["global_step"]
    spec = zoo.get_model_spec(W.NAME, width=W.SIZE, height=W.SIZE)
    init = _numpy(W.fresh_state(spec).model.state_dict())
    got = _numpy(r0["state"])

    ref_metrics, ref_state = _port_one_process(case)
    assert r0["global_step"] == len(ref_metrics) == W.CASES[case][1]
    for m, g in zip(ref_metrics, r0["metrics"]):
        assert g.keys() == m.keys()
        for k, v in m.items():
            if k == "loss":
                assert g[k] == pytest.approx(v, rel=1e-4), k
            else:
                assert g[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    _check_state(got, _numpy(ref_state), init, "1-process port")

    losses, jparams, jbn = _jax_mesh(case)
    for g, jl in zip(r0["metrics"], losses):
        assert g["loss"] == pytest.approx(jl, rel=1e-4)
    jstate = _numpy(weights.to_train_state(spec, jparams, jbn))
    _check_state(got, jstate, init, "JAX 2-device mesh")
