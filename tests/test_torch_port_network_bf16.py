"""Port network (`Darknet`) vs the JAX executor `network.apply`, in bf16.

The same numpy-seeded weights and inputs go through both packages in bf16,
the port routing its kernel layers through their plain versions (CPU).
The bound is loose — 2% of each decoded column's scale, and 2e-3 on the
conf/class probabilities (measured on the CPU: 7e-3 and 1.2e-4) — because
XLA and torch round the bf16 epilogue at different places and the
differences compound over ~100 layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import network as jnet
from tests._torch_port_util import capped_threads, image, nchw, net_pair, rel_err  # noqa: F401


@pytest.mark.parametrize("name,size", [("complex_yolov4_tiny", 128), ("complex_yolov4", 96)])
def test_full_network_bf16(name, size):
    fspec, fparams, model = net_pair(name, size, torch.bfloat16)
    x = image(2, size)
    ref, _ = jnet.apply(fspec, fparams, {}, jnp.asarray(x), use_pallas_conv=False,
                        stem_pallas=False, batch_pack=None)
    ref = np.asarray(ref, np.float32)
    with torch.inference_mode():
        got = model(nchw(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_err(got, ref) < 2e-2, rel_err(got, ref)
    assert np.abs(got[..., 6:] - ref[..., 6:]).max() < 2e-3
