"""The port's bf16 train step and subdivisions vs the JAX package's
`make_train_step`, on the CPU, with the set-up of
test_torch_port_train_step.py (complex_yolov4_tiny at 64 px, batch 2, the
same numpy-seeded weights and batch, LR 1e-3):

- bf16 (the `bn_train` epilogue): the loss within 2e-3 relative and the
  BN running statistics within 2e-2 of each leaf's max |.|. A bf16
  backward through a random network is far from its f32 gradient in
  either package (JAX's own bf16 gradients lie 0.3-57% from its f32 ones
  in relative L2 per leaf, 41% over all leaves), so the port's bf16
  gradient is held to lie no further from JAX's f32 gradient than 1.5x
  JAX's bf16 one does, plus 0.05, per leaf and over all leaves (measured
  1.13x over all leaves, at most 1.34x on a leaf);
- subdivisions 2 against optax `MultiSteps` (the mean rescaled to the
  reference's sum): no parameter moves on the first micro-batch, both move
  alike on the second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.losses.yolo_loss import network_loss as jnetwork_loss
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch import train as T
from complex_yolov4_tpu_torch.models import weights
from tests.test_torch_port_train_step import LR, _close, _compare_state, _jax, _setup


def _grads(spec, model, batch):
    """{name: gradient (JAX layout)} of one port forward and backward."""
    from complex_yolov4_tpu_torch.losses.yolo_loss import network_loss

    heads = model(torch.from_numpy(batch["image"]).permute(0, 3, 1, 2))
    loss, _ = network_loss(spec, heads, torch.from_numpy(batch["targets"]),
                           torch.from_numpy(batch["target_mask"]))
    loss.backward()
    out = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    model.zero_grad()
    return float(loss), {n: g.transpose(2, 3, 1, 0) if n.endswith(".w") else g
                         for n, g in out.items()}


def test_bf16_step_matches_jax():
    spec, params, bn_state, model, batch = _setup(torch.bfloat16)
    jgrads = {}
    for jdt in (jnp.float32, jnp.bfloat16):
        jspec, jstate, jstep = _jax(params, bn_state, "adam", dtype=jdt)

        def loss_fn(p, jdt=jdt, jspec=jspec, bn=jstate.bn_state):
            (_, raw), _ = jnet.apply(jspec, p, bn, jnp.asarray(batch["image"]), train=True,
                                     compute_dtype=jdt, batch_pack=None)
            return jnetwork_loss(jspec, raw, jnp.asarray(batch["targets"]),
                                 jnp.asarray(batch["target_mask"]))[0]
        jgrads[jdt] = jax.jit(jax.grad(loss_fn))(jstate.params)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.float32(LR))
    _, grads = _grads(spec, model, batch)
    model.load_state_dict(weights.to_train_state(spec, params, bn_state))
    state = T.TrainState(model, T.create_optimizer(model))
    metrics = T.make_train_step()(state, batch, LR)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=2e-3)

    def rel_l2(a, ref):
        return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))

    def flat(tree):
        return np.concatenate([np.asarray(tree[n.split(".")[0]][n.split(".")[1]],
                                          np.float32).ravel() for n in grads])

    f32_all, jbf_all = flat(jgrads[jnp.float32]), flat(jgrads[jnp.bfloat16])
    port_all = np.concatenate([g.ravel() for g in grads.values()])
    assert rel_l2(port_all, f32_all) <= 1.5 * rel_l2(jbf_all, f32_all) + 0.05
    for name, g in grads.items():
        key, leaf = name.split(".")
        f32 = np.asarray(jgrads[jnp.float32][key][leaf])
        jbf = np.asarray(jgrads[jnp.bfloat16][key][leaf], np.float32)
        assert rel_l2(g, f32) <= 1.5 * rel_l2(jbf, f32) + 0.05, name
    _, new_bn = weights.from_train_state(spec, model.state_dict())
    for key, entry in new_bn.items():
        for leaf, v in entry.items():
            _close(v, jstate.bn_state[key][leaf], 2e-2, f"{key}.{leaf}")


def test_subdivisions_match_multisteps():
    spec, params, bn_state, model, batch = _setup()
    _, jstate, jstep = _jax(params, bn_state, "sgd", subdivisions=2)
    state = T.TrainState(model, T.create_optimizer(model, optimizer_type="sgd"))
    step = T.make_train_step(subdivisions=2)
    w0 = model.layer0.w.detach().clone()
    second = {**batch, "image": batch["image"][::-1].copy(),
              "targets": batch["targets"][::-1].copy(),
              "target_mask": batch["target_mask"][::-1].copy()}
    for i, b in enumerate((batch, second)):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(LR))
        step(state, b, LR)
        if i == 0:  # the first micro-batch only accumulates
            assert torch.equal(model.layer0.w.detach(), w0)
    assert state.global_step == 2
    assert not torch.equal(model.layer0.w.detach(), w0)
    _compare_state(spec, model, jstate, 1e-4)
