"""Worker of the port's data-parallel step tests (tests/test_torch_port_ddp.py).

One rank of a gloo group on the CPU: for every case of `CASES`, a fresh
complex_yolov4_tiny at 64 px (f32) from the numpy-seeded weights, under
`parallel.wrap_ddp`, takes one optimizer step (SGD) on the rank's shard of
the case's global micro-batches, and the rank writes the reported
(global) loss and metrics of each micro-batch and its state dict after the
step to ``<out_dir>/<case>_rank<r>.pt``. The global batch of a micro-batch
is frames [2r, 2r + 1] of rank r, in rank order (`global_batches`).
Imports torch and the port only.

Usage: python _torch_port_ddp_worker.py <port> <rank> <world> <out_dir>
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from complex_yolov4_tpu_torch import parallel, train as T  # noqa: E402
from complex_yolov4_tpu_torch.models import weights, zoo  # noqa: E402
from complex_yolov4_tpu_torch.models.network import TrainDarknet  # noqa: E402

NAME, SIZE, LR, PER_RANK = "complex_yolov4_tiny", 64, 1e-2, 2
# case: (use_giou_loss, subdivisions, remat, valid targets per frame of the
# global batch of 4: frames 0-1 on rank 0, 2-3 on rank 1)
CASES = {
    "mse": (False, 1, False, (3, 1, 2, 4)),
    "giou": (True, 1, False, (3, 1, 2, 4)),
    "subdivisions2": (False, 2, False, (2, 3, 1, 2)),
    "remat": (False, 1, True, (3, 1, 2, 4)),
    "unequal_objects": (False, 1, False, (4, 3, 0, 0)),
}


def global_batches(case, world=2):
    """The case's global micro-batches (numpy, `world * PER_RANK` frames
    each): images and targets from a numpy seed."""
    _, subdivisions, _, counts = CASES[case]
    rng = np.random.default_rng(7)
    b = world * PER_RANK
    out = []
    for _ in range(subdivisions):
        batch = {"image": rng.uniform(size=(b, SIZE, SIZE, 3)).astype(np.float32),
                 "targets": np.zeros((b, 8, 7), np.float32),
                 "target_mask": np.zeros((b, 8), np.float32)}
        for f in range(b):
            for t in range(counts[f]):
                yaw = rng.uniform(-np.pi, np.pi)
                batch["targets"][f, t] = [t % 3, rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9),
                                          rng.uniform(0.05, 0.3), rng.uniform(0.05, 0.4),
                                          np.sin(yaw), np.cos(yaw)]
                batch["target_mask"][f, t] = 1
        out.append(batch)
    return out


def fresh_state(spec):
    params, bn_state = weights.init_params_np(spec, 0)
    model = TrainDarknet(spec, compute_dtype=torch.float32)
    model.load_state_dict(weights.to_train_state(spec, params, bn_state))
    return T.TrainState(model, T.create_optimizer(model, optimizer_type="sgd"))


def run_case(case, rank, world, out_dir):
    use_giou, subdivisions, remat, _ = CASES[case]
    spec = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
    state = fresh_state(spec)
    state.ddp = parallel.wrap_ddp(state.model, "cpu")
    step = T.make_train_step(use_giou_loss=use_giou, subdivisions=subdivisions, remat=remat)
    metrics = []
    for batch in global_batches(case, world):
        shard = {k: v[rank * PER_RANK:(rank + 1) * PER_RANK] for k, v in batch.items()}
        m = step(state, shard, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"metrics": metrics, "global_step": state.global_step,
                "state": state.model.state_dict()},
               os.path.join(out_dir, f"{case}_rank{rank}.pt"))


def main():
    port, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    parallel.initialize_distributed(f"localhost:{port}", world, rank, device="cpu",
                                    timeout_s=240)
    try:
        for case in CASES:
            run_case(case, rank, world, out_dir)
    finally:
        parallel.destroy()
    print(f"RANK {rank} OK", flush=True)


if __name__ == "__main__":
    main()
