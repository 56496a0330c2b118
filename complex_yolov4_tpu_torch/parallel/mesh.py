"""Data parallelism on `torch.distributed`: one process per device.

Counterpart of `complex_yolov4_tpu/parallel/mesh.py` (reference:
src/train.py:29-71, src/models/model_utils.py:41-66). One JAX process
drives all of its host's chips through a 1-D `data` mesh, and XLA inserts
the all-reduces of the jitted step itself. DDP has no in-process
counterpart of that, so the port runs one process per device, as the
reference's `mp.spawn` did:

- ``--num_processes`` is the world size, ``--process_id`` the rank and
  ``--coordinator_address`` the ``tcp://`` rendezvous (`initialize_distributed`);
- rank r takes ``cuda:{r % torch.cuda.device_count()}`` (`cli.common.resolve_device`);
- each process's loader yields its own shard of ``--batch_size`` frames
  (`data.loader`, ``shard_id``/``num_shards``); the global batch is the
  rank-ordered concatenation of the shards, as the JAX package's per-host
  shards (`mesh.py:80-100`).

DDP averages the gradients and nothing else. The parts of the step that
the JAX package computes over the global batch all-reduce over the group
themselves: the train-mode BN statistics and their gradient
(`models/bn_train.py`, through `TrainDarknet.process_group`, which
`wrap_ddp` sets) and the loss's normalisers (`losses/yolo_loss.py`).

The process group is chosen from the device: NCCL for a CUDA device, gloo
for the CPU; `backend` names another explicitly (gloo carries CUDA tensors
through the host, which lets two ranks share one card, as NCCL does not).
Nothing falls back from one backend to another.
"""

from __future__ import annotations

import collections
import datetime
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

# Every collective of the group (barriers included) fails after this long
# instead of waiting forever on a rank that died. The lead's validation of
# a full val split runs while the other ranks wait at a barrier.
DEFAULT_TIMEOUT_S = 1800.0


def _init_method(coordinator_address: str) -> str:
    """``host:port`` or a URL -> the rendezvous URL (``tcp://host:port``)."""
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize_distributed(coordinator_address: Optional[str], num_processes: Optional[int],
                           process_id: Optional[int], *, device="cuda",
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group of `num_processes` ranks as rank
    `process_id`; a no-op at world size 1. Returns whether this process is
    in a group of that size.

    device: this rank's device; the backend is NCCL for a CUDA device and
    gloo for the CPU unless `backend` names one. timeout_s bounds the
    rendezvous and every later collective. A process that already joined
    a group as this rank of this world keeps it (a caller that chose the
    backend itself, then runs `cli.train.main`)."""
    world = int(num_processes or 1)
    if world <= 1:
        return False
    rank = int(process_id or 0)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    if is_distributed():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise ValueError(f"already rank {dist.get_rank()} of {dist.get_world_size()}, "
                             f"not {rank} of {world}")
        return True
    if not coordinator_address:
        raise ValueError("--num_processes > 1 needs --coordinator_address host:port")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_shard_info() -> Dict[str, int]:
    """This process's position for input sharding: shard_id (the rank),
    num_shards (the world size), local_device_count (the CUDA devices this
    host shows, 1 without CUDA) and global_device_count (one device per
    process: the world size)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if is_distributed() else (0, 1)
    return {"shard_id": rank, "num_shards": world,
            "local_device_count": max(torch.cuda.device_count(), 1),
            "global_device_count": world}


def make_mesh_for_batch(global_batch: int,
                        devices: Optional[Sequence] = None) -> List[torch.device]:
    """The largest prefix of `devices` (default: every local CUDA device)
    whose size divides `global_batch`: the devices one batch is split over
    (`evaluation.evaluator.make_inference_fn(devices=...)`)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh_for_batch: no CUDA device (pass devices=)")
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    while n > 1 and global_batch % n != 0:
        n -= 1
    return devs[:n]


def wrap_ddp(model: nn.Module, device) -> DistributedDataParallel:
    """`model` under DDP on the default group (the world), and that group
    set as the model's `process_group`, which its train-mode BN all-reduces
    over. Buffers are not broadcast: the running statistics come from the
    global batch statistics, so they are equal on every rank already."""
    device = torch.device(device)
    model.process_group = dist.group.WORLD
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def device_prefetch(iterator: Iterable[Dict], device, keys: Sequence[str],
                    depth: int = 2, host_keys: Sequence[str] = ()) -> Iterator[Dict]:
    """Batches of `iterator` with `keys` copied to `device` `depth` batches
    ahead: on CUDA from pinned host memory with non-blocking copies, so the
    transfer overlaps the step that runs meanwhile (the reference's
    pin_memory / non_blocking, train.py:203-204). Keys absent from a batch
    are skipped; `host_keys` pass through as they are (the multiscale
    `size`)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(v):
        t = torch.as_tensor(v)
        if cuda:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    buf: collections.deque = collections.deque()
    it = iter(iterator)
    while True:
        while len(buf) < depth:
            host = next(it, None)
            if host is None:
                break
            dev = {k: put(host[k]) for k in keys if k in host}
            dev.update({k: host[k] for k in host_keys if k in host})
            buf.append(dev)
        if not buf:
            return
        yield buf.popleft()


def barrier() -> None:
    """Wait for every rank (bounded by the group's timeout); a no-op
    without a group."""
    if is_distributed():
        dist.barrier()


def destroy() -> None:
    """Leave the default process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()
