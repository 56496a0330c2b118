"""Port COO raster (torch) is bit-exact against the JAX device raster.

`make_bev_map_from_cells` is two unique-index scatters plus an unsigned bit
unpack of the packed cell key; the same packed inputs must give the same
f32 raster bit for bit, including keys whose 18-bit height sits in the
int32 sign bit (hq >= 2^17) and a capacity that truncates the batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu_torch.data import bev as tbev
from complex_yolov4_tpu_torch.data import synthetic
from tests._torch_port_util import capped_threads  # noqa: F401


def _frames(n):
    cells, keys = [], []
    for s in range(n):
        pts = synthetic.sample_scene(np.random.default_rng(10 + s),
                                     clustered=s % 2 == 1)[0]
        pts = tbev.remove_points_outside(pts)
        # one point near the top of the z range: hq >= 2^17, a negative key
        pts = np.concatenate([pts, np.array([[20.0, 3.0, 3.9, 0.7]], np.float32)])
        c, k = tbev.aggregate_bev_cells(pts)
        cells.append(c)
        keys.append(k)
    return cells, keys


@pytest.mark.parametrize("truncate", [False, True])
def test_raster_bit_exact(truncate):
    cells_l, keys_l = _frames(2)
    assert min(int(k.min()) for k in keys_l) < 0  # sign-bit keys present
    total = sum(len(c) for c in cells_l)
    cap = total - 2000 if truncate else total + 300
    cells, keys, dens = tbev.pack_cells_flat(cells_l, keys_l, cap)
    ref = np.asarray(jbev.make_bev_map_from_cells(
        jnp.asarray(cells), jnp.asarray(keys), jnp.asarray(dens), 2))
    got = tbev.make_bev_map_from_cells(torch.from_numpy(cells), torch.from_numpy(keys),
                                       torch.from_numpy(dens), 2).numpy()
    assert got.shape == ref.shape == (2, 608, 608, 3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert got[..., 1].max() > 0.5  # the high cell came through unsigned
