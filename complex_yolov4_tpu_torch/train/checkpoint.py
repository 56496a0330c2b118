"""Checkpoints of the train state: one `torch.save` file per epoch.

Counterpart of `complex_yolov4_tpu/train/checkpoint.py` (reference:
src/utils/train_utils.py:80-104, src/train.py:96-117). A checkpoint
``<dir>/epoch_<N>.ckpt`` holds the parameters and BN statistics in the JAX
tree layout (numpy, HWIO; `weights.from_train_state`), the optimizer's
state dict, `global_step` and the epoch. `save_checkpoint_async` copies the
state on the device first (the next step may change it), then a background
thread brings the copy to the host and writes it; `wait_for_async_save`
joins that thread and re-raises its error. A write goes to a temporary
file renamed into place, so an interrupted save never leaves half a file.
`cli.common.load_weights` reads the parameters of such a file for
`--pretrained_path`.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import weights
from .trainer import TrainState

_FILE_RE = re.compile(r"^epoch_(\d+)\.ckpt$")

_ASYNC_SAVER: Optional[threading.Thread] = None
_ASYNC_ERROR: Optional[BaseException] = None


def checkpoint_path(checkpoints_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(checkpoints_dir), f"epoch_{epoch}.ckpt")


def _map_tensors(fn, v):
    """`fn` applied to every tensor of a nest of dicts and lists."""
    if isinstance(v, torch.Tensor):
        return fn(v)
    if isinstance(v, dict):
        return {k: _map_tensors(fn, x) for k, x in v.items()}
    if isinstance(v, list):
        return [_map_tensors(fn, x) for x in v]
    return v


def _snapshot(state: TrainState) -> Dict[str, Any]:
    """A copy of the state's tensors on their device, and the step."""
    def clone(t):
        return t.detach().clone()

    return {"model": _map_tensors(clone, state.model.state_dict()),
            "optimizer": _map_tensors(clone, state.optimizer.state_dict()),
            "global_step": int(state.global_step)}


def _write(spec, checkpoints_dir: str, snap: Dict[str, Any], epoch: int) -> str:
    os.makedirs(checkpoints_dir, exist_ok=True)
    path = checkpoint_path(checkpoints_dir, epoch)
    params, bn_state = weights.from_train_state(spec, snap["model"])
    payload = {"params": params, "bn_state": bn_state,
               "optimizer": _map_tensors(torch.Tensor.cpu, snap["optimizer"]),
               "global_step": snap["global_step"], "epoch": int(epoch)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint_async(checkpoints_dir: str, state: TrainState, epoch: int) -> None:
    """Save without stalling the train loop: the state is copied on the
    device now, and a daemon thread moves the copy to the host and writes
    it. At most one save is in flight; a second call joins the first."""
    global _ASYNC_SAVER
    wait_for_async_save()
    snap = _snapshot(state)
    done = None
    if state.device.type == "cuda":
        # the copies are queued on the current stream; the thread's reads
        # must not start before they are done
        done = torch.cuda.Event()
        done.record()
    spec = state.model.spec

    def run():
        global _ASYNC_ERROR
        try:
            if done is not None:
                done.synchronize()
            _write(spec, checkpoints_dir, snap, epoch)
        except BaseException as e:  # noqa: BLE001 -- re-raised at the join
            _ASYNC_ERROR = e

    _ASYNC_SAVER = threading.Thread(target=run, daemon=True, name=f"ckpt-save-epoch{epoch}")
    _ASYNC_SAVER.start()


def wait_for_async_save() -> None:
    """Block until an in-flight async save has finished; re-raise the error
    it hit (a silently lost checkpoint must not look like a good run)."""
    global _ASYNC_SAVER, _ASYNC_ERROR
    if _ASYNC_SAVER is not None and _ASYNC_SAVER.is_alive():
        _ASYNC_SAVER.join()
    _ASYNC_SAVER = None
    if _ASYNC_ERROR is not None:
        err, _ASYNC_ERROR = _ASYNC_ERROR, None
        raise RuntimeError("async checkpoint save failed") from err


def latest_epoch(checkpoints_dir: str) -> Optional[int]:
    if not os.path.isdir(checkpoints_dir):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(checkpoints_dir) if (m := _FILE_RE.match(f))]
    return max(epochs) if epochs else None


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=False)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Load a checkpoint written by `save_checkpoint_async` into `state` (its
    module, optimizer and global_step, in place, on the state's device).
    Returns (state, epoch)."""
    ck = _load(path)
    spec = state.model.spec
    sd = weights.to_train_state(spec, ck["params"], ck["bn_state"])
    state.model.load_state_dict(sd)
    state.optimizer.load_state_dict(ck["optimizer"])
    state.global_step = int(ck["global_step"])
    return state, int(ck["epoch"])


def restore_params_and_bn(path: str):
    """(params, bn_state) numpy trees (JAX layout) of a checkpoint file."""
    ck = _load(path)
    return ck["params"], ck["bn_state"]
