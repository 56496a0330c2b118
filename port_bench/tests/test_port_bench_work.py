"""The frozen work arithmetic: each configuration's operations per frame,
its int8 layer set, and the layer list frozen from the port's topology."""

import pytest

from port_bench import harness
from port_bench.frozen import work

CONFIGS = {"complex_yolov4-608": (127.2, 68, 0.603)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_operations_per_frame(name):
    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    gflop, n_int8, share = CONFIGS[name]
    total = work.flops_per_frame(cfg["layers"], cfg["img_size"])
    assert round(total / 1e9, 1) == gflop
    shapes = work.conv_shapes(cfg["layers"], cfg["img_size"])
    int8 = sum(work.conv_flops(shapes[i]) for i in cfg["int8_layers"])
    assert len(cfg["int8_layers"]) == n_int8
    assert round(int8 / total, 3) == share


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layers_are_the_ports(name):
    from complex_yolov4_tpu_torch.models import quantize, zoo
    from complex_yolov4_tpu_torch.models.spec import ConvSpec

    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    spec = zoo.get_model_spec(cfg["model"], width=608, height=608)
    assert harness.layers_of(spec) == cfg["layers"]
    skip = quantize.default_skip(spec)
    assert cfg["int8_layers"] == [i for i, layer in enumerate(spec.layers)
                                  if isinstance(layer, ConvSpec) and i not in skip]


def test_range_bounds_are_lower_bounds():
    """Splitting a network into ranges never raises the bound of a layer's
    operations, and the edge bytes of a range stay under its layers' own."""
    cfg = harness.read_json(harness.HERE / "configs" / "complex_yolov4-608.json")
    layers, q = cfg["layers"], cfg["int8_layers"]
    early = work.range_bound_s(layers, 608, 16, q, 0, 23)
    late = work.range_bound_s(layers, 608, 16, q, 24, None)
    ops = work.peak_seconds_per_frame(layers, 608, q) * 16
    assert early + late >= ops
    assert early == pytest.approx(work.peak_seconds_per_frame(layers[:24], 608, q) * 16)
    assert work.peak_seconds_per_frame(layers, 608, q) == pytest.approx(89.82e-6, rel=1e-3)
