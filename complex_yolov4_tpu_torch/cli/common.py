"""Shared CLI plumbing: model resolution, weight loading, dataset setup,
device and model construction.

Counterpart of `complex_yolov4_tpu/cli/common.py` (`resolve_spec`,
`load_weights`, `init_or_load`, `resolve_dataset_dir`, `maybe_quantize`).
Unlike the JAX package, which serves f32 with BN unfolded, the port always
folds BN into the convs (in float64, `weights.fold_batchnorm`) and hands
back the `Darknet` on the requested device.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import synthetic
from ..models import quantize as qz
from ..models import weights
from ..models import weights_io as wio
from ..models.darknet_cfg import netspec_from_cfg
from ..models.network import Darknet
from ..models.spec import NetSpec
from ..models.zoo import get_model_spec


def resolve_spec(config) -> NetSpec:
    """Model topology from --model (zoo) or --cfgfile (darknet DSL)."""
    if getattr(config, "cfgfile", None):
        return netspec_from_cfg(config.cfgfile,
                                name=os.path.basename(config.cfgfile))
    return get_model_spec(config.model)


def load_weights(spec: NetSpec, path: str) -> Tuple[dict, dict]:
    """Dispatch on checkpoint flavor: darknet `.weights`, torch `.pth` /
    `.pt` or the port's train checkpoint `.ckpt` -> numpy (params, state)
    trees."""
    if path.endswith(".weights"):
        return wio.load_darknet_weights(spec, path)
    if path.endswith(".ckpt"):
        from ..train.checkpoint import restore_params_and_bn

        return restore_params_and_bn(path)
    if path.endswith((".pth", ".pt")):
        return wio.load_torch_state_dict(spec, path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a checkpoint directory (orbax), which the port does not read: "
            "convert it with the JAX package's exporter, `python -m "
            "complex_yolov4_tpu.cli.export --pretrained_path DIR --format darknet "
            "--output model.weights`, and pass the .weights file (or write a .ckpt "
            "with the port's `cli.export --format ckpt` from that .weights)")
    raise ValueError(f"unrecognized checkpoint format: {path!r}")


def init_or_load(spec: NetSpec, pretrained_path: Optional[str], seed: int = 0):
    if pretrained_path:
        return load_weights(spec, pretrained_path)
    return weights.init_params_np(spec, seed)


def resolve_dataset_dir(config) -> str:
    """Return the dataset root; with --synthetic, generate one on demand.

    The tree is written into a fresh directory and renamed into place, so a
    process that finds the root finds it whole."""
    if not getattr(config, "synthetic", False):
        return config.dataset_dir
    n = config.synthetic_frames
    root = os.path.join(tempfile.gettempdir(), f"synthetic_kitti_torch_{n}")
    if not os.path.isdir(root):
        tmp = tempfile.mkdtemp(prefix=f"synthetic_kitti_torch_{n}.")
        synthetic.generate_kitti_dataset(
            tmp, num_train=n, num_val=max(n // 2, 1),
            num_test=max(n // 4, 1), seed=0)
        try:
            os.rename(tmp, root)
        except OSError:  # another process put its tree there first
            shutil.rmtree(tmp, ignore_errors=True)
    return root


def resolve_device(config) -> torch.device:
    """--device: "cuda" (the default) needs a CUDA device and raises without
    one; "cpu" runs every kernel's plain version. A training process takes
    one device, ``cuda:{--process_id % device count}`` for a bare "cuda"
    (one process per device, `parallel`)."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if dev.type == "cuda" and dev.index is None and hasattr(config, "process_id"):
        dev = torch.device("cuda", config.process_id % torch.cuda.device_count())
    return dev


def compute_dtype_of(config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config.compute_dtype]


def maybe_quantize(spec: NetSpec, params, state, config, loader,
                   device: torch.device) -> Darknet:
    """The serving `Darknet` on `device`, BN folded. With --quantize int8:
    calibrate on the first `config.calib_batches` image batches of `loader`
    and quantize by `default_skip` (models/quantize.py), calibrating in the
    compute dtype as the JAX package does. FUSED_STAGE=1 runs
    the CSP stages on the fused-stage kernel in bf16, as the JAX package's
    `network._use_fused_default` does."""
    dtype = compute_dtype_of(config)
    fused = os.environ.get("FUSED_STAGE", "") == "1" and dtype == torch.bfloat16
    folded = weights.fold_batchnorm(spec, params, state)
    state_t = weights.from_folded(spec, folded)
    if getattr(config, "quantize", "none") != "int8":
        return Darknet(spec, state_t, compute_dtype=dtype, device=device,
                       fused_stages=fused)
    calib = []
    # (the loader's prefetch thread shuts itself down when the loop breaks)
    for i, batch in enumerate(loader):
        if i >= max(int(config.calib_batches), 1):
            break
        calib.append(np.asarray(batch["image"]))
    tree = qz.quantize_model(spec, folded, calib, device=device, compute_dtype=dtype)
    print(f"PTQ int8: {len(tree)} of {len(folded)} convs quantized "
          f"({len(calib)} calibration batches)")
    return Darknet(spec, state_t, compute_dtype=dtype, device=device,
                   quant=weights.from_jax_quant(spec, tree), fused_stages=fused)
