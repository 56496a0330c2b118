"""The port's evaluation slice vs the JAX package's.

A 4-frame synthetic val tree -> val loader (points, flat COO cells, or
host-rastered images) -> `make_inference_fn` (device raster, resize to 160,
network, decode, rotated NMS at k=256) -> `evaluate_map` (rotated-IoU
matching, per-class AP) in both packages: complex_yolov4_tiny, f32, the
same numpy-seeded weights with BN folded (the JAX package serves the same
folded tree). Per-sample statistics (each sample's rows as a set: scores
within ~1e-6 of each other may leave top-k in swapped order) and the
metric dict must be equal, and live detections must exist.

Random weights put thousands of candidates near conf 0.5, so each layout's
conf_thresh sits in a gap of at least 1e-4 in the sorted confidences
(`gap_threshold`, from the port's decoded heads, which match the JAX
package's to ~1e-6), leaving fewer than k candidates per frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu.evaluation import evaluator as jev
from complex_yolov4_tpu.evaluation import metrics as JM
from complex_yolov4_tpu.models import get_model_spec
from complex_yolov4_tpu.models import network as jnet
from complex_yolov4_tpu_torch.data import bev, loader as tloader, synthetic
from complex_yolov4_tpu_torch.evaluation import evaluator as tev
from complex_yolov4_tpu_torch.evaluation import metrics as TM
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet

from tests._torch_port_util import gap_threshold

NAME = "complex_yolov4_tiny"
SIZE = 160
K = 256
SCORE_TOL = 1e-5  # f32 detections of two implementations


class Resized:
    """An image-layout loader whose rasters are resized to SIZE (the same
    arrays for both packages: the JAX evaluator takes images as they come)."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            yield dict(b, image=bev.resize_images(torch.from_numpy(b["image"]), SIZE).numpy())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=0, num_val=4,
        num_test=0, seed=1)
    spec = zoo.get_model_spec(NAME)
    params, state = weights.init_params_np(spec, seed=5)
    jspec = get_model_spec(NAME)
    fparams = jnet.fold_batchnorm(jspec, params, state)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=torch.device("cpu"))
    return root, jnet.fold_spec(jspec), fparams, model


def _loaders(root, layout):
    kw = dict(device_raster=layout != "images", cells_raster=layout == "cells")
    jl, tl = jloader.create_val_loader(root, 2, **kw), tloader.create_val_loader(root, 2, **kw)
    # the JAX loader's prefetch thread can drop its end-of-data mark when
    # its queue is full and leave a slow consumer waiting forever
    # (test_torch_port_copies.py::test_val_loader_slow_consumer_sees_the_end)
    jl.prefetch = 0
    if layout == "images":
        jl, tl = Resized(jl), Resized(tl)
    return jl, tl


def _images(batch):
    """The port's network input of a batch, at SIZE."""
    if "image" in batch:
        return torch.from_numpy(batch["image"])
    if "cells" in batch:
        img = bev.make_bev_map_from_cells(*(torch.from_numpy(batch[k]) for k in
                                            ("cells", "cell_keys", "cell_dens")),
                                          batch["batch_cap"])[:batch["batch"]]
        return bev.resize_images(img, SIZE)
    return bev.images_from_deferred_batch(
        {k: torch.from_numpy(batch[k]) for k in
         ("points", "point_mask", "flip", "holes", "hole_mask")}, SIZE)


def _recorded(monkeypatch, module):
    """Record the per-sample statistics `evaluate_map` hands summarize_map."""
    seen = []
    real = module.summarize_map

    def record(stats, labels):
        seen.append((list(stats), list(labels)))
        return real(stats, labels)

    monkeypatch.setattr(module, "summarize_map", record)
    return seen


@pytest.mark.parametrize("layout", ["points", "cells", "images"])
def test_evaluate_map_matches_jax(setup, layout, monkeypatch):
    root, fspec, fparams, model = setup
    jl, tl = _loaders(root, layout)
    with torch.inference_mode():
        conf = torch.cat([model(_images(b).permute(0, 3, 1, 2))[..., 6] for b in tl])
    conf_thresh = gap_threshold(conf.numpy(), K)

    flags = dict(from_points=layout == "points", from_cells=layout == "cells")
    jinfer = jev.make_inference_fn(fspec, conf_thresh=conf_thresh, nms_thresh=0.5,
                                   max_boxes=K, compute_dtype=jnp.float32,
                                   img_size=SIZE, batch_pack=None, **flags)
    tinfer = tev.make_inference_fn(conf_thresh=conf_thresh, nms_thresh=0.5,
                                   max_boxes=K, img_size=SIZE, **flags)
    jseen, tseen = _recorded(monkeypatch, JM), _recorded(monkeypatch, TM)
    jout = jev.evaluate_map(jinfer, fparams, {}, jl)
    tout = tev.evaluate_map(tinfer, model, tl)

    (jstats, jlabels), (tstats, tlabels) = jseen[0], tseen[0]
    assert len(jstats) == len(tstats) == 4
    assert sum(len(s[0]) for s in tstats) >= 4  # live detections
    for js, ts in zip(jstats, tstats):
        # rows as sets: candidates whose scores (conf * class prob) lie
        # within ~1e-6 may come out of top-k in swapped order
        jo, to = np.argsort(-js[1], kind="stable"), np.argsort(-ts[1], kind="stable")
        np.testing.assert_array_equal(ts[0][to], js[0][jo])
        np.testing.assert_array_equal(ts[2][to], js[2][jo])
        np.testing.assert_allclose(ts[1][to], js[1][jo], atol=SCORE_TOL, rtol=0)
    for a, b in zip(jlabels, tlabels):
        np.testing.assert_array_equal(a, b)
    assert set(jout) == set(tout)
    for k in jout:
        np.testing.assert_allclose(np.asarray(tout[k]), np.asarray(jout[k]),
                                   atol=1e-9, err_msg=k)
