"""Shared helpers of the PyTorch port's parity tests (not a test module).

It imports no JAX at module level: the card's tests
(`test_torch_port_gpu.py`, run where JAX is absent) import it too, and so
does `chip_smoke.py` for the NMS kernel's heads and near-threshold frames.

Every `test_torch_port_*.py` imports `capped_threads`, an autouse fixture:
under pytest-xdist each worker's torch would otherwise run an intra-op pool
as wide as the machine, and the workers oversubscribe the cores.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def thread_cap() -> int:
    """Intra-op threads of one test process: the machine's cores shared
    among pytest-xdist's workers (1 worker without xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    """torch's intra-op threads capped at `thread_cap()` for the module,
    restored after it. Set per module, not once per process: a module of
    the JAX package's tests on the same worker may set its own count
    (`test_reference_ab.py`'s `ref` fixture sets every core)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(thread_cap())
    yield thread_cap()
    torch.set_num_threads(saved)


def child_env(children: int = 1) -> dict:
    """The environment of a child process a port test starts: the repo on
    PYTHONPATH and, in OMP_NUM_THREADS, its share of the test's thread cap
    among the `children` that run at once."""
    return dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS=str(max(1, thread_cap() // children)))


def net_pair(name, size, dtype, seed=0):
    """(folded JAX spec, folded JAX params, port Darknet on the CPU) from
    the same numpy-seeded weights."""
    from complex_yolov4_tpu.models import get_model_spec
    from complex_yolov4_tpu.models import network as jnet

    spec = zoo.get_model_spec(name, width=size, height=size)
    params, state = weights.init_params_np(spec, seed)
    jspec = get_model_spec(name, width=size, height=size)
    jparams = jnet.fold_batchnorm(jspec, params, state)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=dtype, device=CPU)
    return jnet.fold_spec(jspec), jparams, model


def image(b, size, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def rel_err(got, ref):
    """Max abs difference over (B, N), relative to each column's scale."""
    scale = np.abs(ref).max(axis=(0, 1)) + 1e-6  # per column
    return float((np.abs(got - ref).max(axis=(0, 1)) / scale).max())


def rms_err(got, ref):
    """The sighted checks' statistic over (B, N, C): per column the RMS of
    the difference relative to the column's RMS, the largest column's. A
    sighted bf16 network carries one-ulp differences to the heads, so the
    largest single difference (`rel_err`) reads several percent between two
    correct implementations, where the RMS reads about half that and a
    planted fault moves both to the column's own size."""
    diff = np.sqrt(((got - ref) ** 2).mean(axis=(0, 1)))
    return float((diff / np.sqrt((ref ** 2).mean(axis=(0, 1)))).max())


def gap_threshold(conf, k, min_gap=1e-4):
    """A confidence threshold in a >= min_gap gap of the sorted (B, N)
    confidences with between 4 and k-1 candidates at or above it in every
    frame: top-k then takes all of them, and 1e-6 differences between two
    correct implementations cannot move a candidate across it."""
    s = np.sort(conf.ravel())[::-1]
    best = None
    for i in range(len(s) - 1):
        t = 0.5 * (s[i] + s[i + 1])
        counts = (conf >= t).sum(axis=1)
        if counts.max() >= k:
            break
        if s[i] - s[i + 1] >= min_gap and counts.min() >= 4:
            best = float(t)
    assert best is not None, "no usable confidence gap"
    return best


def free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def start_workers(script, args_of_rank, world=2, cwd=_REPO):
    """Start `world` processes `python <script> <args_of_rank(rank)>`, which
    share the test's thread cap (`child_env`), each writing its output to a
    temporary file; `wait_workers` collects them."""
    procs = []
    for r in range(world):
        log = tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen([sys.executable, *script, *args_of_rank(r)], cwd=cwd,
                                       stdout=log, stderr=subprocess.STDOUT, text=True,
                                       env=child_env(world)), log))
    return procs


def wait_workers(procs):
    """Wait for the processes of `start_workers` and return their outputs;
    fails on a non-zero exit. The test phase's time limit
    (`tests/_time_limit.py`) bounds the wait; every process still running
    when it ends, on that limit or any other exception, is killed."""
    try:
        for p, _ in procs:
            p.wait()
        outs = []
        for p, log in procs:
            log.seek(0)
            outs.append(log.read())
    finally:
        for p, log in procs:
            p.kill()
            p.wait()
            log.close()
    for r, ((p, _), out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def run_workers(script, args_of_rank, world=2, cwd=_REPO):
    """`start_workers`, then `wait_workers`."""
    return wait_workers(start_workers(script, args_of_rank, world, cwd))


def nms_heads(seed, b, n, classes=3):
    """(B, N, 7 + classes) f32 decoded heads: boxes jittered around 12
    centres a frame, so that many overlap, and continuous scores, so that
    no two candidates tie."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 580, (b, 12, 2))
    pick = rng.integers(0, 12, (b, n))
    xy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 4, (b, n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (b, n)) * 0.2 + (pick % 3) * 0.5
    d = np.concatenate([xy, rng.uniform(8, 40, (b, n, 2)), np.sin(yaw)[..., None],
                        np.cos(yaw)[..., None], rng.uniform(0.2, 1.0, (b, n, 1)),
                        rng.uniform(0.0, 1.0, (b, n, classes))], axis=-1).astype(np.float32)
    return torch.from_numpy(d)


def nms_near_threshold(d, conf, thr, k):
    """(B,) bool: the frame holds two valid candidates of one class whose
    plain IoU lies within 1e-5 of thr. The NMS kernel sums in another order
    than PyTorch's reductions, so such a pair may decide the other way."""
    from complex_yolov4_tpu_torch.ops import nms as nms_mod
    from complex_yolov4_tpu_torch.ops import rotated_boxes as rb

    cand, valid = nms_mod._candidates(d, conf, k)
    b5 = torch.stack([cand[..., 0], cand[..., 1], cand[..., 2], cand[..., 3],
                      torch.atan2(cand[..., 4], cand[..., 5])], dim=-1)
    ii, jj = torch.triu_indices(k, k, 1, device=d.device)
    iou = rb.rotated_iou(b5[:, ii], b5[:, jj])
    near = ((iou - thr).abs() < 1e-5) & valid[:, ii] & valid[:, jj]
    near &= cand[:, ii, 8] == cand[:, jj, 8]
    return near.any(1).cpu()
