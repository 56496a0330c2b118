"""How far the bounds of chip_smoke.py's phase 8 lie from faulty data-parallel
steps, and how far the 608 step moves under small input changes, on the card.

    python3 ddp_fault_probe.py

Run from the repo root on a machine with one CUDA card. It takes phase 8's
pieces from chip_smoke.py (the global batch of 4 at 608, the seed-0
complex_yolov4 weights, SGD, the noise floor and the bounds) and:

- in two gloo processes sharing the card (as phase 8 (b)), takes the
  data-parallel step in f32 (TF32 off) and in bf16 once per entry of
  FAULTS, each from a fresh state with one fault planted in memory for that
  step (the code on disk is not changed):
  - none: the control, which must pass the bounds;
  - bn_local: train-mode BN on the rank's own batch (statistics and
    gradient), as plain DDP without a global-batch BN computes it;
  - bn_backward_local: the backward's all-reduce of sum(g) and
    sum(g * xhat) dropped (the forward's statistics stay global);
  - loss_unscaled: the rank's loss share not scaled by the world size
    before the backward;
  - loss_local_counts: the loss's counts (matched cells, valid targets,
    noobj and confident cells) not all-reduced: per-rank normalisers;
  and holds each against the 1-process step of its dtype with phase 8's
  criteria (`chip_smoke.ddp_f32_ok`, `chip_smoke.ddp_bf16_ok`);
- in this process, the 1-process step on its input scaled by each factor of
  PERTURB, against the unscaled step of the same dtype, and the 1-process
  bf16 step against the f32 one: whether a bf16-sized change of the input
  (1e-3) moves the f32 step as far as bf16 compute does.

Prints one line per fault and per perturbation, then a JSON summary as its
last line. Exits 1 if a control fails its bounds or a fault passes the f32
bounds (bf16's hold the step by its norm only: a fault that turns the step
without scaling it can pass them; the f32 check runs the same code).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

import chip_smoke as C

FAULTS = ("none", "bn_local", "bn_backward_local", "loss_unscaled", "loss_local_counts")
# (compute dtype, input scale): the 1-process step on the scaled input
PERTURB = ((torch.float32, 1 + 1e-3), (torch.float32, 1 + 1e-2), (torch.bfloat16, 1 + 1e-2))


class _Dist:
    """`torch.distributed` with the named functions replaced."""

    def __init__(self, **replaced):
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(dist, name)


def _skip(*args, **kwargs):
    return None


@contextlib.contextmanager
def planted(fault: str):
    """The port with `fault` (FAULTS) planted in memory, restored on exit."""
    from complex_yolov4_tpu_torch.losses import yolo_loss
    from complex_yolov4_tpu_torch.models import bn_train as bnt
    from complex_yolov4_tpu_torch.models import network
    from complex_yolov4_tpu_torch.train import trainer

    saved = []

    def put(obj, name, value):
        saved.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, value)

    if fault == "bn_local":
        full = network.bn_train
        put(network, "bn_train", lambda h, scale, bias, group=None: full(h, scale, bias, None))
    elif fault == "bn_backward_local":
        backward = bnt._BNTrain.backward

        def local_backward(ctx, *grads):
            bnt.dist = _Dist(all_reduce=_skip)
            try:
                return backward(ctx, *grads)
            finally:
                bnt.dist = dist

        put(bnt._BNTrain, "backward", staticmethod(local_backward))
    elif fault == "loss_unscaled":
        put(trainer, "dist", _Dist(get_world_size=lambda group=None: 1))
    elif fault == "loss_local_counts":
        put(yolo_loss, "dist", _Dist(all_reduce=_skip))
    elif fault != "none":
        raise ValueError(f"unknown fault {fault}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def rank_main(rank: int, port: str, out_dir: str) -> None:
    """One rank of the gloo pair: the step under each fault in each dtype;
    rank 0 saves (loss, state dict) to OUT_DIR/<fault>_<dtype>.pt."""
    from complex_yolov4_tpu_torch import parallel
    from complex_yolov4_tpu_torch import train as T

    dev = torch.device("cuda", 0)
    parallel.initialize_distributed(f"localhost:{port}", C.DDP_RANKS, rank, device=dev,
                                    backend="gloo", timeout_s=C.DDP_TIMEOUT_S)
    try:
        shard = C.ddp_shard(C.ddp_global_batch(), rank)
        for dtype in (torch.float32, torch.bfloat16):
            for fault in FAULTS:
                state = C.ddp_state(dtype, dev)
                state.ddp = parallel.wrap_ddp(state.model, dev)
                with planted(fault):
                    loss = float(T.make_train_step()(state, shard, C.DDP_LR)["loss"])
                if rank == 0:
                    torch.save({"loss": loss, "state": {k: v.cpu() for k, v in
                                                        state.model.state_dict().items()}},
                               os.path.join(out_dir, f"{fault}_{str(dtype)[6:]}.pt"))
                del state
    finally:
        parallel.destroy()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ddp_fault_probe.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="ddp_fault_probe_") as out_dir:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   port, out_dir], cwd=here, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(C.DDP_RANKS)]
        try:
            batch = C.ddp_global_batch()
            init = C.ddp_init(dev)
            ref = C.plain_step(batch, torch.float32, dev)
            probes = [C.step_distance(C.plain_step(batch, torch.float32, dev, x)[1], ref[1], init)
                      for x in C.DDP_PROBES]
            floor = {k: max(p[k] for p in probes) for k in probes[0]}
            ref16 = C.plain_step(batch, torch.bfloat16, dev)
            summary = {"floor": floor, "perturb": {}, "faults": {}}
            for dtype, scale in PERTURB:
                base = ref if dtype == torch.float32 else ref16
                d = C.step_distance(C.plain_step(batch, dtype, dev, scale)[1], base[1], init)
                name = f"{str(dtype)[6:]} x {scale!r}"
                summary["perturb"][name] = d
                print(f"[perturb] 1-process {str(dtype)[6:]} step, input x {scale!r} vs x 1: "
                      f"step relative L2 {d['step_l2']:.4g}, norm ratio {d['norm_ratio']:.4g}, "
                      f"params max abs diff {d['param_abs']:.4g}, BN statistics relative L2 "
                      f"{d['bn_l2']:.4g}")
            d = C.step_distance(ref16[1], ref[1], init)
            summary["perturb"]["bfloat16 vs float32"] = d
            print(f"[perturb] 1-process bf16 step vs f32 step: step relative L2 "
                  f"{d['step_l2']:.4g}, norm ratio {d['norm_ratio']:.4g}, params max abs diff "
                  f"{d['param_abs']:.4g}, BN statistics relative L2 {d['bn_l2']:.4g}")
            outs = [p.communicate(timeout=C.DDP_TIMEOUT_S)[0] for p in procs]
        except BaseException:
            C.kill_ranks(procs)
            raise
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-6000:])
                raise SystemExit(f"rank {r} exited {p.returncode}")
        escaped = []
        for name in ("float32", "bfloat16"):
            base = ref if name == "float32" else ref16
            for fault in FAULTS:
                got = torch.load(os.path.join(out_dir, f"{fault}_{name}.pt"),
                                 weights_only=False)
                label = f"fault {fault}, {name}: 2 gloo ranks x {C.DDP_PER_RANK} vs 1 process"
                if name == "float32":
                    ok = C.ddp_f32_ok(label, got["loss"], got["state"], ref, floor, init)
                else:
                    ok = C.ddp_bf16_ok(label, got["loss"], got["state"], ref16, ref, init)
                d = C.step_distance(got["state"], base[1], init)
                summary["faults"][f"{fault} {name}"] = dict(d, loss=got["loss"],
                                                           ref_loss=base[0], passes=ok)
                if (fault == "none" and not ok) or (fault != "none" and ok
                                                    and name == "float32"):
                    escaped.append(f"{fault} {name}")
    summary["bound"] = {"step_l2": C.DDP_FLOOR_MARGIN * floor["step_l2"],
                        "param_abs": C.DDP_FLOOR_MARGIN * floor["param_abs"],
                        "loss_rel": C.DDP_LOSS_REL, "bn_rel": C.DDP_BN_REL}
    passed16 = [f for f in FAULTS[1:] if summary["faults"][f"{f} bfloat16"]["passes"]]
    print(f"[fault] phase 8's f32 bound: step relative L2 <= {summary['bound']['step_l2']:.4g}, "
          f"params max abs diff <= {summary['bound']['param_abs']:.4g}; "
          + ("every f32 fault fails it and both controls pass" if not escaped
             else f"NOT AS EXPECTED: {escaped}")
          + f"; faults that pass the bf16 check: {passed16 or 'none'}")
    print(json.dumps(summary))
    if escaped:
        sys.exit(1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
