"""The port's train step vs the JAX package's `make_train_step`, on the CPU
(bf16 and subdivisions: test_torch_port_train_bf16.py).

complex_yolov4_tiny at 64 px, batch 2, the same numpy-seeded weights
(`init_params_np`), the same batch (numpy images or deferred points) and
LR through both packages:

- f32, Adam and SGD (Nesterov, momentum 0.949), weight decay 5e-4 on conv
  kernels only: the loss, the gradients of every leaf, the parameters after
  one optimizer step and the BN running statistics, each leaf within 1e-4
  of its max |.| (JAX: XLA's f32 convs; the port: torch's, TF32 never on
  the CPU; summation order differs, measured 1-2e-5). Adam's first step
  moves an element by lr * g / (|g| + 1e-8), about +-lr for any g above
  the summation noise, so its parameters are held at 1e-4 where |g| >
  1e-3 max |g| and within the 2 lr an Adam step can move elsewhere;
- the checkpoint round trip (`save_checkpoint_async` / `restore_checkpoint`) and
  a resume that continues `global_step` and the optimizer's moments: the
  next step from the restored state equals the next step from the live one;
- the deferred (device-raster) batch gives the same step as its images;
- the eval step (running BN statistics) against JAX's `make_eval_step`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu import train as JT
from complex_yolov4_tpu.losses.yolo_loss import network_loss as jnetwork_loss
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch import train as T
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import TrainDarknet

NAME, SIZE, LR = "complex_yolov4_tiny", 64, 1e-3


def _setup(dtype=torch.float32):
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    params, bn_state = weights.init_params_np(spec, 0)
    model = TrainDarknet(spec, compute_dtype=dtype)
    model.load_state_dict(weights.to_train_state(spec, params, bn_state))
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
    return spec, params, bn_state, model, batch


def _jax(params, bn_state, optimizer_type, subdivisions=1, dtype=jnp.float32):
    jspec = get_model_spec(NAME, width=SIZE, height=SIZE)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, bn_state)
    tx = JT.create_optimizer(jp, optimizer_type=optimizer_type, subdivisions=subdivisions)
    state = JT.TrainState.create(jp, jb, tx)
    step = JT.make_train_step(jspec, tx, compute_dtype=dtype, batch_pack=None)
    return jspec, state, step


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), (what, err, np.abs(ref).max())


def _compare_state(spec, model, jstate, tol):
    params, bn_state = weights.from_train_state(spec, model.state_dict())
    for key, entry in params.items():
        for name, v in entry.items():
            _close(v, jstate.params[key][name], tol, f"{key}.{name}")
    for key, entry in bn_state.items():
        for name, v in entry.items():
            _close(v, jstate.bn_state[key][name], tol, f"{key}.{name}")


@pytest.mark.parametrize("optimizer_type", ["adam", "sgd"])
def test_f32_step_matches_jax(optimizer_type):
    spec, params, bn_state, model, batch = _setup()
    jspec, jstate, jstep = _jax(params, bn_state, optimizer_type)

    # gradients of every leaf, from the same forward
    def loss_fn(p):
        (_, raw), _ = jnet.apply(jspec, p, jstate.bn_state, jnp.asarray(batch["image"]),
                                 train=True, compute_dtype=jnp.float32, batch_pack=None)
        return jnetwork_loss(jspec, raw, jnp.asarray(batch["targets"]),
                             jnp.asarray(batch["target_mask"]))[0]
    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params)

    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.float32(LR))
    optimizer = T.create_optimizer(model, optimizer_type=optimizer_type)
    state = T.TrainState(model, optimizer)
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    metrics = T.make_train_step()(state, batch, LR)
    assert state.global_step == 1 and int(jstate.global_step) == 1
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    for k in jmetrics:
        if k.startswith("head"):
            assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-3, abs=1e-5), k
    for name, g in grads.items():
        key, leaf = name.split(".")
        ref = np.asarray(jgrads[key][leaf])
        got = g.numpy().transpose(2, 3, 1, 0) if leaf == "w" else g.numpy()
        _close(got, ref, 1e-4, f"grad {name}")
    if optimizer_type == "sgd":
        _compare_state(spec, model, jstate, 1e-4)
        return
    new_params, new_bn = weights.from_train_state(spec, model.state_dict())
    for key, entry in new_params.items():
        for leaf, v in entry.items():
            g = np.abs(np.asarray(jgrads[key][leaf]))
            ref = np.asarray(jstate.params[key][leaf])
            sure = g > 1e-3 * g.max()
            _close(v[sure], ref[sure], 1e-4 * np.abs(ref).max() / np.abs(ref[sure]).max(),
                   f"{key}.{leaf}")
            assert np.abs(v - ref).max() <= 2 * LR * (1 + 1e-3), f"{key}.{leaf}"
    for key, entry in new_bn.items():
        for leaf, v in entry.items():
            _close(v, jstate.bn_state[key][leaf], 1e-4, f"{key}.{leaf}")


def test_checkpoint_roundtrip_and_resume(tmp_path):
    spec, params, bn_state, model, batch = _setup()
    state = T.TrainState(model, T.create_optimizer(model))
    step = T.make_train_step()
    step(state, batch, LR)
    T.save_checkpoint_async(str(tmp_path), state, epoch=3)
    T.wait_for_async_save()
    assert T.latest_epoch(str(tmp_path)) == 3
    path = T.checkpoint_path(str(tmp_path), 3)

    fresh = TrainDarknet(spec, compute_dtype=torch.float32)
    restored = T.TrainState(fresh, T.create_optimizer(fresh))
    restored, epoch = T.restore_checkpoint(path, restored)
    assert epoch == 3 and restored.global_step == 1
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
    # the next step continues the optimizer's moments and the step count
    step(state, batch, LR)
    step(restored, batch, LR)
    assert restored.global_step == state.global_step == 2
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
    p2, s2 = T.restore_params_and_bn(path)
    assert p2.keys() == params.keys() and s2.keys() == bn_state.keys()


def test_deferred_batch_steps_like_images():
    """A deferred points batch rastered on the device gives the same step as
    the host raster of the same points."""
    from complex_yolov4_tpu_torch.data import bev, synthetic

    spec, params, bn_state, model, batch = _setup()
    rng = np.random.default_rng(5)
    clouds = [bev.remove_points_outside(synthetic.sample_scene(rng)[0]) for _ in range(2)]
    pts, pmask = zip(*(bev.pad_points(c, 20480) for c in clouds))
    deferred = {"points": np.stack(pts), "point_mask": np.stack(pmask),
                "flip": np.array([0.0, 1.0], np.float32),
                "holes": np.zeros((2, 1, 5), np.float32), "hole_mask": np.zeros((2, 1), np.float32),
                "targets": batch["targets"], "target_mask": batch["target_mask"]}
    from complex_yolov4_tpu_torch.train.trainer import batch_images

    images = batch_images(deferred, torch.device("cpu"), SIZE).permute(0, 2, 3, 1).numpy()
    twin = TrainDarknet(spec, compute_dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    a = T.TrainState(model, T.create_optimizer(model))
    b = T.TrainState(twin, T.create_optimizer(twin))
    la = T.make_train_step()(a, deferred, LR, SIZE)["loss"]
    lb = T.make_train_step()(b, {**batch, "image": images}, LR)["loss"]
    assert float(la) == float(lb)
    for (n, x), (_, y) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(x, y), n


def test_eval_step_matches_jax():
    """The validation loss with the running BN statistics (no update), f32:
    the total and the per-head losses within 1e-4 relative of JAX's
    `make_eval_step`; the module's state is left as it was."""
    spec, params, bn_state, model, batch = _setup()
    jspec = get_model_spec(NAME, width=SIZE, height=SIZE)
    jtotal, jmetrics = JT.make_eval_step(jspec, compute_dtype=jnp.float32)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, bn_state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    total, metrics = T.make_eval_step()(model, batch)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-4)
    for tm, jm in zip(metrics, jmetrics):
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
