"""The benchmark's frozen copies and references against the port's plain
versions, on the CPU: scene generation and COO equal to the bit, the
reference raster equal to the served one, the reference NMS, decode and
sighted weights equal to the port's within their arithmetic, and the row
comparison that judges served detections."""

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.frozen import scenes, weights as frozen_weights
from port_bench.reference import darknet, nms as ref_nms, raster as ref_raster


@pytest.mark.parametrize("clustered", [True, False])
def test_scenes_and_coo_equal_the_ports(clustered):
    from complex_yolov4_tpu_torch.data import bev, synthetic

    for i in range(3):
        ours = scenes.sample_scene(scenes.scene_rng(2 ** 33 + 1, "pool", i), clustered=clustered)
        port = synthetic.sample_scene(scenes.scene_rng(2 ** 33 + 1, "pool", i),
                                      clustered=clustered)
        assert all(np.array_equal(a, b) for a, b in zip(ours, port))
        cells, keys = scenes.aggregate_cells(scenes.remove_points_outside(ours[0]))
        want = bev.aggregate_bev_cells(bev.remove_points_outside(port[0]))
        assert np.array_equal(cells, want[0]) and np.array_equal(keys, want[1])


def test_reference_raster_equals_the_served_raster():
    from complex_yolov4_tpu_torch.data import bev

    clouds = [scenes.remove_points_outside(
        scenes.sample_scene(scenes.scene_rng(7, "pool", i), clustered=True)[0]) for i in range(2)]
    cells, keys = zip(*(scenes.aggregate_cells(c) for c in clouds))
    coo = scenes.pack_cells_flat(cells, keys, 2 * 15360)
    served = bev.make_bev_map_from_cells(*(torch.as_tensor(a) for a in coo), 2)
    assert torch.equal(served, ref_raster.raster(clouds, "cpu"))


def _decoded(seed, frames=3, n=3000):
    """Random decoded boxes (frames, n, 10) with distinct scores."""
    rng = np.random.default_rng(seed)
    d = np.zeros((frames, n, 10), np.float32)
    d[..., 0:2] = rng.uniform(0, 608, (frames, n, 2))
    d[..., 2:4] = rng.uniform(8, 70, (frames, n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (frames, n))
    d[..., 4], d[..., 5] = np.sin(yaw), np.cos(yaw)
    d[..., 6:] = rng.uniform(0, 1, (frames, n, 4))
    return d


def _by_score(rows):
    return rows[np.lexsort((rows[:, 1], rows[:, 0], -(rows[:, 6] * rows[:, 7])))]


def test_reference_nms_agrees_with_the_ports():
    from complex_yolov4_tpu_torch.ops.nms import nms_batch

    d = _decoded(3)
    dets, masks = nms_batch(torch.from_numpy(d), 0.5, 0.5, 64)
    for b, (want, _, _) in enumerate(ref_nms.nms(d, 0.5, 0.5, 64)):
        kept = dets[b].numpy()[masks[b].numpy() > 0.5]
        assert len(kept) == len(want) > 10
        np.testing.assert_allclose(_by_score(kept), _by_score(want), rtol=1e-5, atol=1e-3)


def test_row_gaps_score_served_rows():
    """Rows of the frame's own boxes, and the reference NMS's own merged
    rows, read 0, the merged ones not clean; nudged rows read the nudge in
    head units; another frame's rows, and rows naming the class ranked
    last, read far more; rows of boxes far down the ranking read a score
    gap."""
    d = torch.from_numpy(_decoded(5, frames=2))
    d[..., 2:4] *= 4  # large boxes, so that groups merge
    stride = torch.full((d.shape[1],), 8.0, dtype=torch.float64)
    answers = ref_nms.nms(d.numpy(), 0.5, 0.5, 64)

    def row_gaps(rows, frame):
        gap, _, score = ref_nms.row_gaps(rows, d[frame], stride, 0.5, 64, *answers[frame])
        return gap, score

    def rows_of(at):
        return torch.cat([d[0, at, :7], d[0, at, 7:].max(-1, keepdim=True).values,
                          d[0, at, 7:].argmax(-1, keepdim=True).float()], -1)

    kept, kept_index, grouped = answers[0]
    gap, clean, score = ref_nms.row_gaps(torch.from_numpy(kept).float(), d[0], stride,
                                         0.5, 64, *answers[0])
    assert float(gap.max()) < 1e-5 and float(score.max()) == 0.0
    assert len(grouped) > 0
    assert clean.tolist() == [int(i) not in set(grouped.tolist()) for i in kept_index]
    idx = torch.arange(0, 600, 10)
    rows = rows_of(idx)
    gap, _ = row_gaps(rows, 0)
    assert float(gap.max()) < 1e-5
    nudged = rows.clone()
    nudged[:, 0] += 0.8  # a tenth of a cell
    gap, _ = row_gaps(nudged, 0)
    assert torch.allclose(gap, torch.full_like(gap, 0.1), atol=1e-4)
    gap, _ = row_gaps(rows, 1)
    assert float(gap.median()) > 0.3
    last = rows.clone()
    last[:, 8] = d[0, idx, 7:].argmin(-1).float()
    gap, _ = row_gaps(last, 0)
    assert float(gap.median()) > 0.3
    last[0, 8] = 7  # no such class
    gap, _ = row_gaps(last, 0)
    assert float(gap[0]) == float("inf")
    # the frame's 64 best candidates read no score gap; boxes far down do
    p = d[0].double()
    best = torch.where(p[:, 6] >= 0.5, p[:, 6] * p[:, 7:].amax(-1), torch.zeros_like(p[:, 6]))
    order = best.argsort(descending=True)
    for at, low, high in ((order[:64], 0.0, 1e-9), (order[-500:-440], 1.0, float("inf"))):
        _, score = row_gaps(rows_of(at), 0)
        assert low <= float(score.median()) <= high


def test_reference_decode_equals_the_ports():
    from complex_yolov4_tpu_torch.models import zoo
    from complex_yolov4_tpu_torch.models.yolo_head import decode_head

    cfg = harness.read_json(harness.HERE / "configs" / "complex_yolov4-608.json")
    spec = zoo.get_model_spec("complex_yolov4")
    yolos = [layer for layer in cfg["layers"] if layer["type"] == "yolo"]
    gen = torch.Generator().manual_seed(0)
    strides = ref_nms.box_strides(cfg["layers"], 608, "cpu")
    at = 0
    for i, y in zip(spec.yolo_indices, yolos):
        g = 608 // y["stride"]
        feat = torch.randn(2, 30, g, g, generator=gen)
        want = decode_head(feat, spec.layers[i], 608)
        assert torch.allclose(darknet.decode(feat, y, 608), want, rtol=1e-6, atol=1e-4)
        assert torch.all(strides[at:at + want.shape[1]] == 608 / g)
        at += want.shape[1]
    assert at == len(strides)


def test_sighted_weights_equal_the_ports():
    from complex_yolov4_tpu_torch.models import sighted, weights, zoo

    spec = zoo.get_model_spec("complex_yolov4_tiny", width=96, height=96)
    layers = harness.layers_of(spec)
    params = frozen_weights.init_params(layers, 11, "cpu")
    tree = {f"layer{i}": {k: (v.permute(2, 3, 1, 0) if k == "w" else v).numpy()
                          for k, v in p.items() if k not in ("mean", "var")}
            for i, p in params.items()}
    state = {f"layer{i}": {"mean": p["mean"].numpy(), "var": p["var"].numpy()}
             for i, p in params.items() if "mean" in p}
    image = np.random.default_rng(4).uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    port = weights.fold_batchnorm(spec, *sighted.sighted_params_np(spec, tree, state, image))
    ours = frozen_weights.sighted_folded(layers, params, torch.as_tensor(image))
    for i, (w, b) in ours.items():
        np.testing.assert_allclose(w.permute(2, 3, 1, 0).numpy(), port[f"layer{i}"]["w"],
                                   rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), port[f"layer{i}"]["b"], rtol=2e-3, atol=1e-6)
