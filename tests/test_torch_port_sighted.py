"""Whole-network checks that can see the early backbone: sighted weights.

With `init_params_np`'s weights (uniform in +-sqrt(1/fan_in)) each conv
shrinks its input about 3x against the folded biases, so the input's share
of complex_yolov4's heads decays about 10x every 15 layers: a whole-network
check on those weights passes whatever layers 0 to about 60 compute
(zeroing layer 1's weights moves the seed-0 heads by under 1e-4 of their
column scale). `models/sighted.py` `sighted_params_np` rescales every conv to unit RMS
on one seeded image; the same numpy trees go to the JAX package and to the
port.

The sighted checks: complex_yolov4 at 96, port against JAX (jitted, as
the JAX package runs), f32 and bf16, on the decoded heads' `rms_err` (per
column the RMS difference relative to the column's RMS, the largest
column's). Their tolerances are 1.5x the largest floor measured on the
CPU, port against JAX on the same sighted weights (weight seeds 0 and 1,
sighting images 1 and 2, inputs 0 and 3, eight readings a dtype), as the
card's sighted checks in `chip_smoke.py` are set:
- f32: 2.8e-6 to 4.3e-6, tolerance 7e-6;
- bf16: 1.9e-2 to 2.3e-2 (XLA and torch round the bf16 epilogues at other
  places, and a sighted network carries the differences to the heads),
  tolerance 3.5e-2.
The largest single difference (`rel_err`) reads 4.5e-6 to 1.1e-5 in f32
and 2.8e-2 to 4.9e-2 in bf16 there: against a planted fault's 0.69-0.83
it leaves too little room in bf16.

Planted faults, port side only: the conv weights of the stem (layer 0), a
3x3 layer (1), a layer inside fused segment 2-10 (8) and the first conv
that `quantize.default_skip` leaves to int8 (25) zeroed in turn. Each must
move the sighted check by at least 10x its tolerance; measured on weight
seed 0, sighting image 1, input 0: 0.65-0.78 in both dtypes (f32 9e4x its
tolerance and more, bf16 18.5-22x).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.models import quantize, weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet
from complex_yolov4_tpu_torch.models.sighted import sighted_params_np
from complex_yolov4_tpu_torch.models.spec import ConvSpec
from tests._torch_port_util import (CPU, capped_threads, image, nchw, rel_err,  # noqa: F401
                                    rms_err)

NAME, SIZE = "complex_yolov4", 96
# the `rms_err` tolerance of each sighted check
TOL = {"f32": 7e-6, "bf16": 3.5e-2}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
BLIND_TOL = 1e-4  # the seed-0 f32 check's bound (test_full_network_f32)


def _first_int8_conv(spec):
    skip = quantize.default_skip(spec)
    return min(i for i, layer in enumerate(spec.layers)
               if isinstance(layer, ConvSpec) and i not in skip)


SPEC = zoo.get_model_spec(NAME, width=SIZE, height=SIZE)
FAULTS = {"stem": 0, "3x3": 1, "fused_2_10": 8, "int8": _first_int8_conv(SPEC)}


def _zeroed(params, layer):
    out = {k: dict(v) for k, v in params.items()}
    out[f"layer{layer}"]["w"] = np.zeros_like(out[f"layer{layer}"]["w"])
    return out


def _port(params, state, dtype):
    model = Darknet(SPEC, weights.from_jax_params(SPEC, params, state), compute_dtype=dtype,
                    device=CPU)
    with torch.inference_mode():
        return model(nchw(image(2, SIZE))).float().numpy()


@pytest.fixture(scope="module")
def sighted():
    """The sighted trees and the JAX package's heads on them, per dtype."""
    params, state = weights.init_params_np(SPEC, 0)
    params, state = sighted_params_np(SPEC, params, state, image(1, SIZE, seed=1))
    jspec = get_model_spec(NAME, width=SIZE, height=SIZE)
    jparams = jnet.fold_batchnorm(jspec, params, state)
    refs = {}
    for key, (_, jdt) in DTYPES.items():
        apply = jax.jit(functools.partial(jnet.apply, jnet.fold_spec(jspec), compute_dtype=jdt,
                                          use_pallas_conv=False, stem_pallas=False,
                                          batch_pack=None))
        refs[key] = np.asarray(apply(jparams, {}, jnp.asarray(image(2, SIZE)))[0], np.float32)
    return params, state, refs


def test_fault_layers():
    """The planted faults sit where the hand kernels do at 608: the stem on
    layer 0, the 3x3 kernel on layer 1, fused segment 2-10, an int8 conv."""
    assert FAULTS["int8"] == 25
    assert all(isinstance(SPEC.layers[i], ConvSpec) for i in FAULTS.values())
    assert 2 <= FAULTS["fused_2_10"] <= 10


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sighted_network_matches_jax(sighted, dtype):
    params, state, refs = sighted
    got = _port(params, state, DTYPES[dtype][0])
    assert got.shape == refs[dtype].shape == (2, SPEC.num_boxes(SIZE), 10)
    assert np.isfinite(got).all()
    err = rms_err(got, refs[dtype])
    assert err < TOL[dtype], err


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_planted_fault_moves_sighted_check(sighted, dtype, fault):
    params, state, refs = sighted
    got = _port(_zeroed(params, FAULTS[fault]), state, DTYPES[dtype][0])
    err = rms_err(got, refs[dtype])
    assert err >= 10.0 * TOL[dtype], err


def test_seed0_heads_blind_to_layer1(sighted):
    """Layer 1's weights zeroed: the seed-0 heads move by under the blind
    check's 1e-4 (`rel_err`, its statistic), the sighted heads by at least
    10x the sighted f32 tolerance (port against port)."""
    params, state = weights.init_params_np(SPEC, 0)
    blind = rel_err(_port(_zeroed(params, 1), state, torch.float32),
                    _port(params, state, torch.float32))
    assert blind < BLIND_TOL, blind
    params, state, _ = sighted
    seen = rms_err(_port(_zeroed(params, 1), state, torch.float32),
                   _port(params, state, torch.float32))
    assert seen >= 10.0 * TOL["f32"], seen
