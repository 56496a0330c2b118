"""The port's serving slice end to end vs the JAX package's.

Synthetic scenes -> host COO aggregation -> `make_inference_fn(
from_cells=True)` (raster, network, decode, rotated NMS) in both packages:
complex_yolov4_tiny at 608, batch 2, f32, the same bridged weights. Keep
sets must be equal and detections within 1e-3 px.

Random weights put thousands of candidates near conf 0.5, so a top-k
boundary at k=64 could flip on 1e-6 differences between two correct
implementations. The test therefore sets conf_thresh inside a gap of at
least 1e-4 in the sorted JAX confidences, leaving fewer than k candidates
per frame: top-k then takes all of them. Scores (conf * class prob) of
the candidates still sit within ~1e-6 of each other, so two
non-overlapping detections may come out in swapped order: rows are
matched as sets.
"""

import jax.numpy as jnp
import numpy as np
import torch

from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu.evaluation.evaluator import make_inference_fn as jax_make_inference_fn
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.data import bev, synthetic
from complex_yolov4_tpu_torch.evaluation.evaluator import make_inference_fn
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

from tests._torch_port_util import gap_threshold

K = 64
NMS = 0.5


def test_slice_matches_jax():
    spec = zoo.get_model_spec("complex_yolov4_tiny")
    params, state = weights.init_params_np(spec, seed=3)
    jspec = get_model_spec("complex_yolov4_tiny")
    fspec = jnet.fold_spec(jspec)
    fparams = jnet.fold_batchnorm(jspec, params, state)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=torch.device("cpu"))

    cells_l, keys_l = [], []
    for s in range(2):
        pts = synthetic.sample_scene(np.random.default_rng(100 + s), clustered=s == 1)[0]
        c, k = bev.aggregate_bev_cells(bev.remove_points_outside(pts))
        cells_l.append(c)
        keys_l.append(k)
    cap = sum(len(c) for c in cells_l) + 1024
    cells, keys, dens = bev.pack_cells_flat(cells_l, keys_l, cap)

    # the JAX network's confidences pick the threshold
    img = jbev.make_bev_map_from_cells(jnp.asarray(cells), jnp.asarray(keys),
                                       jnp.asarray(dens), 2)
    decoded, _ = jnet.apply(fspec, fparams, {}, img, compute_dtype=jnp.float32,
                            use_pallas_conv=False, stem_pallas=False, batch_pack=None)
    conf_thresh = gap_threshold(np.asarray(decoded)[..., 6], K)

    jinfer = jax_make_inference_fn(fspec, conf_thresh=conf_thresh, nms_thresh=NMS,
                                   max_boxes=K, compute_dtype=jnp.float32,
                                   from_cells=True, batch_pack=None)
    jd, jm = jinfer(fparams, {}, cells, keys, dens, 2)
    jd, jm = np.asarray(jd), np.asarray(jm)

    infer = make_inference_fn(conf_thresh=conf_thresh, nms_thresh=NMS, max_boxes=K,
                              from_cells=True)
    td, tm = infer(model, cells, keys, dens, 2)
    assert td.shape == jd.shape == (2, K, 9) and tm.shape == jm.shape == (2, K)
    assert np.isfinite(td.numpy()).all()
    assert jm.sum() >= 4
    np.testing.assert_array_equal(tm.numpy().sum(1), jm.sum(1))
    for b in range(2):
        j_rows = jd[b][jm[b] > 0]
        t_rows = td.numpy()[b][tm.numpy()[b] > 0]
        dist = np.abs(j_rows[:, None, :] - t_rows[None, :, :]).max(-1)
        match = dist.argmin(1)
        assert len(set(match.tolist())) == len(j_rows)  # a bijection
        assert dist[np.arange(len(j_rows)), match].max() < 1e-3
