"""Shared helpers of the PyTorch port's parity tests (not a test module)."""

import numpy as np
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

CPU = torch.device("cpu")


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
