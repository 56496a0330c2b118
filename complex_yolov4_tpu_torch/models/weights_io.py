"""Weight interop: darknet binary `.weights` and PyTorch `.pth` ingestion.

Formats (behavioral contract):

- darknet binary (reference: src/models/darknet_utils.py:199-246,
  src/models/darknet2pytorch.py:403-446): 5 little-endian int32 header
  (major, minor, revision, seen, _), then a flat float32 stream per conv
  layer in topology order — BN convs as [bn_bias, bn_scale, running_mean,
  running_var, kernel(OIHW)], plain convs as [bias, kernel(OIHW)];
- PyTorch state dicts from the reference Darknet module: tensors appear in
  module order with the same per-conv role sequence (kernel, then BN
  gamma/beta/mean/var or conv bias), so ingestion is a shape-driven walk —
  no dependency on the reference's key naming.

Axis mapping: torch/darknet kernels are OIHW; the JAX package's trees
store HWIO, so kernels transpose (2, 3, 1, 0) on the way in and back.

Counterpart of `complex_yolov4_tpu/models/weights_io.py`: the readers return
the numpy (params, state) trees of the JAX package's layout, which
`weights.from_jax_params` folds into the port's module state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from .spec import ConvSpec, NetSpec

# The JAX package's parameter and BN-state trees, as numpy:
# {"layer{i}": {"w", "bn_scale", "bn_bias"} | {"w", "b"}} and
# {"layer{i}": {"mean", "var"}}
Params = Dict[str, Dict[str, np.ndarray]]
State = Dict[str, Dict[str, np.ndarray]]

_HEADER = np.array([0, 2, 0, 0, 0], dtype=np.int32)


def _conv_layers(spec: NetSpec) -> List[Tuple[int, ConvSpec, int]]:
    """[(layer_index, spec, in_channels)] for every conv in order."""
    chans = (spec.in_channels,) + spec.out_channels()
    return [
        (i, l, chans[i])
        for i, l in enumerate(spec.layers)
        if isinstance(l, ConvSpec)
    ]


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def load_darknet_weights(spec: NetSpec, path: str) -> Tuple[Params, State]:
    """Read a darknet `.weights` file into (params, state) for `spec`."""
    with open(path, "rb") as f:
        header = np.fromfile(f, count=5, dtype=np.int32)
        del header
        buf = np.fromfile(f, dtype=np.float32)

    params: Params = {}
    state: State = {}
    start = 0

    def take(n: int) -> np.ndarray:
        nonlocal start
        if start + n > buf.size:
            raise ValueError(
                f"weight file truncated: need {start + n} floats, have {buf.size}")
        out = buf[start : start + n]
        start += n
        return out

    for i, layer, cin in _conv_layers(spec):
        cout, k = layer.filters, layer.size
        n_w = cout * cin * k * k
        entry: Dict[str, Any] = {}
        if layer.batch_normalize:
            entry["bn_bias"] = take(cout).copy()
            entry["bn_scale"] = take(cout).copy()
            state[f"layer{i}"] = {
                "mean": take(cout).copy(),
                "var": take(cout).copy(),
            }
        else:
            entry["b"] = take(cout).copy()
        entry["w"] = _oihw_to_hwio(take(n_w).reshape(cout, cin, k, k))
        params[f"layer{i}"] = entry

    if start != buf.size:
        raise ValueError(
            f"weight file size mismatch: consumed {start} of {buf.size} floats")
    return params, state


def save_darknet_weights(spec: NetSpec, params: Params, state: State,
                         path: str, seen: int = 0) -> None:
    """Write (params, state) as a darknet `.weights` file."""
    header = _HEADER.copy()
    header[3] = seen
    with open(path, "wb") as f:
        header.tofile(f)
        for i, layer, _ in _conv_layers(spec):
            p = params[f"layer{i}"]
            if layer.batch_normalize:
                st = state[f"layer{i}"]
                np.asarray(p["bn_bias"], np.float32).tofile(f)
                np.asarray(p["bn_scale"], np.float32).tofile(f)
                np.asarray(st["mean"], np.float32).tofile(f)
                np.asarray(st["var"], np.float32).tofile(f)
            else:
                np.asarray(p["b"], np.float32).tofile(f)
            _hwio_to_oihw(np.asarray(p["w"], np.float32)).tofile(f)


def load_torch_state_dict(
    spec: NetSpec, source: Union[str, Dict[str, Any]]
) -> Tuple[Params, State]:
    """Ingest a reference-style PyTorch state dict (path to `.pth` or an
    in-memory dict). Tensors are consumed in insertion order and matched to
    conv layers by shape, so any equivalent-topology checkpoint loads."""
    if isinstance(source, str):
        sd = torch.load(source, map_location="cpu")
        tensors = [(k, v.numpy()) for k, v in sd.items() if hasattr(v, "numpy")]
    else:
        tensors = [(k, np.asarray(v)) for k, v in source.items()]

    # Drop bookkeeping entries (num_batches_tracked etc.).
    stream = [
        (k, v) for k, v in tensors
        if v.ndim >= 1 and not k.endswith("num_batches_tracked")
    ]
    pos = 0

    def take(expect_shape) -> np.ndarray:
        nonlocal pos
        if pos >= len(stream):
            raise ValueError("state dict exhausted before all convs were filled")
        key, v = stream[pos]
        if tuple(v.shape) != tuple(expect_shape):
            raise ValueError(
                f"shape mismatch at {key!r}: got {tuple(v.shape)}, want {tuple(expect_shape)}")
        pos += 1
        return v.astype(np.float32)

    params: Params = {}
    state: State = {}
    for i, layer, cin in _conv_layers(spec):
        cout, k = layer.filters, layer.size
        entry: Dict[str, Any] = {
            "w": _oihw_to_hwio(take((cout, cin, k, k)))
        }
        if layer.batch_normalize:
            entry["bn_scale"] = take((cout,))
            entry["bn_bias"] = take((cout,))
            state[f"layer{i}"] = {
                "mean": take((cout,)),
                "var": take((cout,)),
            }
        else:
            entry["b"] = take((cout,))
        params[f"layer{i}"] = entry
    if pos != len(stream):
        raise ValueError(
            f"state dict has {len(stream) - pos} unconsumed tensors")
    return params, state
