"""Shared helpers of the PyTorch port's parity tests (not a test module)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bound on every child process of the data-parallel tests
WORKER_TIMEOUT_S = 240


def net_pair(name, size, dtype, seed=0):
    """(folded JAX spec, folded JAX params, port Darknet on the CPU) from
    the same numpy-seeded weights."""
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


def run_workers(script, args_of_rank, world=2, timeout=WORKER_TIMEOUT_S, cwd=_REPO):
    """Start `world` processes `python <script> <args_of_rank(rank)>`, wait
    for all within `timeout` seconds (killing every one when it runs out),
    and return their outputs; fails on a non-zero exit. Each process gets 2
    intra-op threads: the suite runs beside it on the same cores."""
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, *script, *args_of_rank(r)], cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"workers {script} did not finish in {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs
