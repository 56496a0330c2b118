"""Port network (`Darknet`) vs the JAX executor `network.apply`.

Same numpy-seeded weights (`init_params_np`, BN folded by both packages in
float64) and the same inputs go through both. Two kinds of check:

- with the kernels: the port's routed layers (stem on layer 0, conv3x3 on
  1 and 6) against `apply(stem_pallas=True, use_pallas_conv=True)` with
  the Pallas kernels in interpret mode; bf16, tolerance 2e-2 (the JAX
  kernel tests' own);
- the whole network in f32: decoded (B, N, 10) within rel 1e-4 of the
  column scale (f32 convs summed in different orders by XLA and torch).

The whole network in bf16 is in test_torch_port_network_bf16.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu.ops import pallas_conv
from tests._torch_port_util import capped_threads, image, nchw, net_pair, rel_err  # noqa: F401


@pytest.mark.parametrize("size,stop_after", [(192, 0), (256, 6)])
def test_kernel_layers_match_pallas(monkeypatch, size, stop_after):
    fspec, fparams, model = net_pair("complex_yolov4", size, torch.bfloat16)
    routes = model.routes(size)
    assert routes[0] == "stem"
    if stop_after == 6:
        assert routes[1] == routes[6] == "conv3x3"
    x = image(1, size)
    monkeypatch.setattr(pallas_conv, "ENABLED", True)
    with pltpu.force_tpu_interpret_mode():
        live, _ = jnet.apply(fspec, fparams, {}, jnp.asarray(x), stop_after=stop_after,
                             stem_pallas=True, use_pallas_conv=True, batch_pack=None)
    ref = np.asarray(live[-1], np.float32)
    with torch.inference_mode():
        got = model(nchw(x), stop_after=stop_after)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,size", [("complex_yolov4_tiny", 128), ("complex_yolov4", 96)])
def test_full_network_f32(name, size):
    fspec, fparams, model = net_pair(name, size, torch.float32)
    x = image(2, size)
    ref, _ = jnet.apply(fspec, fparams, {}, jnp.asarray(x), compute_dtype=jnp.float32,
                        use_pallas_conv=False, stem_pallas=False)
    ref = np.asarray(ref)
    with torch.inference_mode():
        got = model(nchw(x)).numpy()
    assert got.shape == ref.shape == (2, fspec.num_boxes(size), 10)
    assert np.isfinite(got).all()
    err = rel_err(got, ref)
    assert err < 1e-4, err
