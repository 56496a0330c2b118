"""The PyTorch port's copies of jax-free modules equal their originals.

complex_yolov4_tpu_torch carries copies of the pure-Python / numpy pieces
of the serving and evaluation paths (layer IR, model zoo, darknet cfg, KITTI
constants and parsing, frame transforms and augmentations, targets,
synthetic scenes and trees, host rasters, the train, test and eval CLI
configs, the dataset with its mosaic and the loader, the LR schedules, the
logger and meters, the visualization and the HTML viewer, the train/val
split tool, and the native rasterizer's C++ source) so that it never imports JAX; each copy is held
here to the JAX package's original: source copies by their syntax trees
(docstrings aside, and the port's `import cv2` inside the functions that
draw, where the original imports it at the top), the C++ source byte for
byte, the rest by their outputs, bit for bit. Also: the port's kernel
routing at 608 and its import hygiene (no jax, no JAX package, no cv2).
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from complex_yolov4_tpu.config import kitti as jcnf
from complex_yolov4_tpu.cli import train_val_split as jtvs
from complex_yolov4_tpu.config import runtime as jrt
from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu.data import dataset as jds
from complex_yolov4_tpu.data import kitti as jkitti
from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu.data import synthetic as jsyn
from complex_yolov4_tpu.data import targets as jtgt
from complex_yolov4_tpu.data import transforms as jtf
from complex_yolov4_tpu.data.dataset import KittiDataset as JDataset
from complex_yolov4_tpu.models import darknet_cfg as jcfg
from complex_yolov4_tpu.models import zoo as jzoo
from complex_yolov4_tpu.train import schedules as jsched
from complex_yolov4_tpu.utils import logger as jlog
from complex_yolov4_tpu.utils import meters as jmeters
from complex_yolov4_tpu.utils import viewer_html as jviewer
from complex_yolov4_tpu.utils import visualization as jviz
from complex_yolov4_tpu_torch.config import kitti as tcnf
from complex_yolov4_tpu_torch.cli import train_val_split as ttvs
from complex_yolov4_tpu_torch.config import runtime as trt
from complex_yolov4_tpu_torch.data import bev as tbev
from complex_yolov4_tpu_torch.data import dataset as tds
from complex_yolov4_tpu_torch.data import kitti as tkitti
from complex_yolov4_tpu_torch.data import loader as tloader
from complex_yolov4_tpu_torch.data import synthetic as tsyn
from complex_yolov4_tpu_torch.data import targets as ttgt
from complex_yolov4_tpu_torch.data import transforms as ttf
from complex_yolov4_tpu_torch.data.dataset import KittiDataset as TDataset
from complex_yolov4_tpu_torch.models import darknet_cfg as tcfg
from complex_yolov4_tpu_torch.models import zoo as tzoo
from complex_yolov4_tpu_torch.models.network import kernel_routes
from complex_yolov4_tpu_torch.train import schedules as tsched
from complex_yolov4_tpu_torch.utils import logger as tlog
from complex_yolov4_tpu_torch.utils import meters as tmeters
from complex_yolov4_tpu_torch.utils import viewer_html as tviewer
from complex_yolov4_tpu_torch.utils import visualization as tviz
from tests._torch_port_util import capped_threads, child_env  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _is_cv2_import(node) -> bool:
    return isinstance(node, ast.Import) and [a.name for a in node.names] == ["cv2"]


def _top_level(module):
    """{name: syntax-tree dump} of a module's top-level functions, classes
    and assignments, docstrings and function-level `import cv2` dropped
    (with the methods of each class under "Class.method" too)."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            node.body = [n for n in node.body if not _is_cv2_import(n)] or [ast.Pass()]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = ast.dump(item)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = ast.dump(node)
    return out


# (JAX module, port module, names copied; None: the whole module)
SOURCE_COPIES = {
    "cli/train_val_split": (jtvs, ttvs, None),
    "config/kitti": (jcnf, tcnf, None),
    "config/runtime": (jrt, trt, ("_add_fields", "_build", "parse_eval_config",
                                  "parse_train_config", "parse_test_config")),
    "data/kitti": (jkitti, tkitti, None),
    "data/transforms": (jtf, ttf, ("_expand44", "camera_to_lidar_points",
                                   "lidar_to_camera_points", "camera_to_lidar_box",
                                   "lidar_to_camera_box", "rotate_z", "lidar_box_rotate_z",
                                   "Compose", "OneOf", "RandomRotation", "RandomScaling",
                                   "HorizontalFlip", "Cutout", "default_lidar_transforms",
                                   "default_aug_transforms")),
    "data/dataset": (jds, tds, ("_ProbeUnsupported", "_AugProbe")
                     + tuple(f"KittiDataset.{m}" for m in (
                         "__len__", "get_lidar", "get_label", "get_calib", "get_image_path",
                         "load_bev_only", "load_sample", "load_mosaic", "_load_mosaic_native",
                         "_load_mosaic_python", "get_item", "_remove_invalid_idx"))),
    "data/loader": (jloader, tloader, ("_MULTISCALE_EVERY", "MAX_POINTS", "MAX_CELLS",
                                       "create_test_loader")),
    "train/schedules": (jsched, tsched, ("multi_step_factor", "cosine_factor", "make_lr_fn")),
    "utils/logger": (jlog, tlog, None),
    "utils/meters": (jmeters, tmeters, ("AverageMeter", "ProgressMeter")),
    "data/targets": (jtgt, ttgt, ("MAX_TARGETS", "build_yolo_targets", "_CLASS_HEIGHT",
                                  "_FIXED_Z", "inverse_yolo_targets")),
    "data/synthetic": (jsyn, tsyn, ("_CLASS_DIMS", "_CLASS_NAMES", "_GROUND_Z",
                                    "_lidar_ground", "sample_scene",
                                    "scene_to_kitti_objects", "generate_kitti_dataset",
                                    "_calib_file_text")),
    "data/bev": (jbev, tbev, ("_GRID", "_LOG64", "_HQ_MAX", "_DENSITY_TABLE",
                              "remove_points_outside", "_cell_indices_np",
                              "make_bev_map", "pad_points", "pack_points_flat",
                              "aggregate_bev_cells", "density_from_keys")),
    "models/darknet_cfg": (jcfg, tcfg, None),
    "utils/viewer_html": (jviewer, tviewer, None),
    "utils/visualization": (jviz, tviz, None),
}


@pytest.mark.parametrize("name", sorted(SOURCE_COPIES))
def test_source_copies_equal(name):
    jmod, tmod, names = SOURCE_COPIES[name]
    j, t = _top_level(jmod), _top_level(tmod)
    if names is None:
        assert set(j) == set(t), name
        names = sorted(j)
    for n in names:
        assert n in j and n in t, (name, n)
        assert j[n] == t[n], (name, n)


def test_eval_config_fields():
    """The port's EvalConfig: the JAX package's fields and defaults, plus
    `device`; the parser gives the same values for the same flags."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jrt.EvalConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(trt.EvalConfig)]
    assert tf == jf + [("device", "cuda")]
    argv = ["--model", "complex_yolov4_tiny", "--batch_size", "3", "--num_samples", "5",
            "--cells_raster", "--quantize", "int8", "--conf_thresh", "0.25"]
    j, t = jrt.parse_eval_config(argv), trt.parse_eval_config(argv + ["--device", "cpu"])
    assert dataclasses.asdict(t) == dict(dataclasses.asdict(j), device="cpu")


def test_native_source_identical():
    """The port's native rasterizer is the JAX package's C++ source, byte for
    byte (the port builds it with its own flags, into its own build
    directory)."""
    src = "native/bev_native.cpp"
    assert ((REPO / "complex_yolov4_tpu_torch" / src).read_bytes()
            == (REPO / "complex_yolov4_tpu" / src).read_bytes())


def test_test_config_fields():
    """The port's TestConfig: the JAX package's fields and defaults, plus
    `device`; the parser gives the same values for the same flags."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jrt.TestConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(trt.TestConfig)]
    assert tf == jf + [("device", "cuda")]
    argv = ["--model", "complex_yolov4_tiny", "--batch_size", "3", "--num_samples", "5",
            "--save_test_output", "--output_format", "video", "--save_3d"]
    j, t = jrt.parse_test_config(argv), trt.parse_test_config(argv + ["--device", "cpu"])
    assert dataclasses.asdict(t) == dict(dataclasses.asdict(j), device="cpu")
    assert t.results_dir == j.results_dir


def test_train_config_fields():
    """The port's TrainConfig: the JAX package's fields and defaults, plus
    `device`; the parser gives the same values for the same flags."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jrt.TrainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(trt.TrainConfig)]
    assert tf == jf + [("device", "cuda")]
    argv = ["--model", "complex_yolov4_tiny", "--batch_size", "3", "--subdivisions", "2",
            "--use_giou_loss", "--steps", "10", "20", "--optimizer_type", "sgd"]
    j, t = jrt.parse_train_config(argv), trt.parse_train_config(argv + ["--device", "cpu"])
    assert dataclasses.asdict(t) == dict(dataclasses.asdict(j), device="cpu")
    assert t.checkpoints_dir == j.checkpoints_dir and t.logs_dir == j.logs_dir


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    """The same synthetic KITTI tree written by each package."""
    base = tmp_path_factory.mktemp("trees")
    kw = dict(num_train=2, num_val=5, num_test=2, seed=4)
    return (jsyn.generate_kitti_dataset(str(base / "jax"), **kw),
            tsyn.generate_kitti_dataset(str(base / "torch"), **kw))


def test_generated_tree_identical(kitti_trees):
    jroot, troot = kitti_trees
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jroot)
                    for d, _, fs in os.walk(jroot) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(d, f), troot)
                    for d, _, fs in os.walk(troot) for f in fs)
    assert jfiles == tfiles and len(jfiles) == 3 * 9 + 3
    for rel in jfiles:
        assert Path(jroot, rel).read_bytes() == Path(troot, rel).read_bytes(), rel


def _assert_batches_equal(jb, tb):
    assert set(jb) == set(tb)
    for k in jb:
        a, b = np.asarray(jb[k]), np.asarray(tb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("mode", ["val", "test"])
def test_dataset_samples_identical(kitti_trees, mode):
    root = kitti_trees[0]
    jd, td = JDataset(root, mode=mode), TDataset(root, mode=mode)
    assert jd.sample_id_list == td.sample_id_list and len(td) > 0
    for i in range(len(td)):
        if mode == "test":
            for a, b in zip(jd.load_bev_only(i), td.load_bev_only(i)):
                np.testing.assert_array_equal(a, b)
            continue
        ja, ta = jd.load_sample(i), td.load_sample(i)
        assert ja[0] == ta[0]
        for a, b in zip(ja[1:], ta[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["image", "points", "cells"])
def test_val_loader_batches_identical(kitti_trees, layout):
    """Seeded order, the drop_last=False tail (5 frames in batches of 2) and
    every array of every batch, in each layout."""
    root = kitti_trees[0]
    kw = dict(device_raster=layout != "image", cells_raster=layout == "cells")
    jl, tl = jloader.create_val_loader(root, 2, **kw), tloader.create_val_loader(root, 2, **kw)
    jl.prefetch = 0  # see test_val_loader_slow_consumer_sees_the_end
    assert len(jl) == len(tl) == 3
    jbs, tbs = list(jl), list(tl)
    assert len(jbs) == len(tbs) == 3
    for jb, tb in zip(jbs, tbs):
        _assert_batches_equal(jb, tb)


def test_val_loader_slow_consumer_sees_the_end(kitti_trees):
    """A consumer slower than the prefetch thread still gets the end of the
    data: the thread's end-of-data mark waits for room in a full queue. (The
    JAX package's loader drops the mark when the queue is full, and its
    consumer then waits forever after the last batch; the tests here read
    the JAX loader without its prefetch thread.)"""
    loader = tloader.create_val_loader(kitti_trees[1], 1, device_raster=True)
    got = []

    def consume():
        for _ in loader:
            time.sleep(0.2)
            got.append(1)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(got) == len(loader) == 5


@pytest.mark.parametrize("name", sorted(jzoo.MODEL_ZOO))
def test_zoo_specs_equal(name):
    js, ts = jzoo.get_model_spec(name), tzoo.get_model_spec(name)
    assert len(js.layers) == len(ts.layers)
    for i, (a, b) in enumerate(zip(js.layers, ts.layers)):
        assert type(a).__name__ == type(b).__name__, i
        assert dataclasses.astuple(a) == dataclasses.astuple(b), i
    assert (js.in_channels, js.width, js.height, js.name) == (
        ts.in_channels, ts.width, ts.height, ts.name)
    assert js.out_channels() == ts.out_channels()
    assert js.out_strides() == ts.out_strides()
    assert js.num_boxes(608) == ts.num_boxes(608)


def test_kitti_constants_equal():
    assert tcnf.BOUNDARY == jcnf.BOUNDARY
    assert (tcnf.BEV_HEIGHT, tcnf.BEV_WIDTH) == (jcnf.BEV_HEIGHT, jcnf.BEV_WIDTH)
    assert tcnf.DISCRETIZATION == jcnf.DISCRETIZATION
    assert tcnf.MAX_HEIGHT == jcnf.MAX_HEIGHT


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_scene_identical(seed, clustered):
    a = jsyn.sample_scene(np.random.default_rng(seed), clustered=clustered)
    b = tsyn.sample_scene(np.random.default_rng(seed), clustered=clustered)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_host_coo_bit_identical():
    clouds = [jsyn.sample_scene(np.random.default_rng(s), clustered=s == 1)[0]
              for s in range(3)]
    jc, tc = [], []
    for pts in clouds:
        a, b = jbev.remove_points_outside(pts), tbev.remove_points_outside(pts)
        np.testing.assert_array_equal(a, b)
        ja, ta = jbev.aggregate_bev_cells(a), tbev.aggregate_bev_cells(b)
        for x, y in zip(ja, ta):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(jbev.density_from_keys(ja[1]),
                                      tbev.density_from_keys(ta[1]))
        jc.append(ja)
        tc.append(ta)
    total = sum(len(c) for c, _ in jc)
    # a roomy capacity with a pad frame, and a truncating one
    for cap, frames in ((total + 512, 4), (total - 1000, None)):
        ja = jbev.pack_cells_flat([c for c, _ in jc], [k for _, k in jc], cap,
                                  total_frames=frames)
        ta = tbev.pack_cells_flat([c for c, _ in tc], [k for _, k in tc], cap,
                                  total_frames=frames)
        for x, y in zip(ja, ta):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_kernel_routes_at_608():
    spec = tzoo.get_model_spec("complex_yolov4")
    routes = kernel_routes(spec, 608)
    assert routes == {0: "stem", 1: "conv3x3", 6: "conv3x3", 11: "conv3x3",
                      16: "conv3x3", 19: "conv3x3"}


def test_kernel_routes_at_608_f32(monkeypatch):
    """f32 compute: no route by default (the JAX executor's
    `pallas_conv.ENABLED` is False as shipped); with `conv3x3.F32_ENABLED`
    the 3x3 kernel's layers, and never a stem (the JAX executor takes its
    stem in bf16 only)."""
    import torch

    from complex_yolov4_tpu_torch.ops import conv3x3

    spec = tzoo.get_model_spec("complex_yolov4")
    assert kernel_routes(spec, 608, torch.float32) == {}
    monkeypatch.setattr(conv3x3, "F32_ENABLED", True)
    assert kernel_routes(spec, 608, torch.float32) == {
        1: "conv3x3", 6: "conv3x3", 11: "conv3x3", 16: "conv3x3", 19: "conv3x3"}


def test_port_imports_no_jax():
    """Every module of the port imports with jax, the JAX package and cv2
    blocked (the card's host has no opencv)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['complex_yolov4_tpu'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import complex_yolov4_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 40, names\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and m.startswith(('jax', 'complex_yolov4_tpu.', 'cv2'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=child_env())
    assert out.returncode == 0, out.stderr


def test_weights_io_equal(tmp_path):
    """Darknet `.weights` written by both packages are the same bytes; a
    `.pth` state dict (reference module order) reads into the same trees."""
    from complex_yolov4_tpu.models import get_model_spec
    from complex_yolov4_tpu.models import weights_io as jwio
    from complex_yolov4_tpu_torch.models import weights, weights_io as twio

    spec, jspec = tzoo.get_model_spec("complex_yolov4_tiny"), get_model_spec("complex_yolov4_tiny")
    params, state = weights.init_params_np(spec, seed=1)
    jwio.save_darknet_weights(jspec, params, state, str(tmp_path / "j.weights"), seen=7)
    twio.save_darknet_weights(spec, params, state, str(tmp_path / "t.weights"), seen=7)
    assert (tmp_path / "j.weights").read_bytes() == (tmp_path / "t.weights").read_bytes()

    import torch

    sd = {}
    for key, p in params.items():
        sd[f"{key}.conv.weight"] = torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())
        if "bn_scale" in p:
            sd[f"{key}.bn.weight"] = torch.from_numpy(p["bn_scale"])
            sd[f"{key}.bn.bias"] = torch.from_numpy(p["bn_bias"])
            sd[f"{key}.bn.running_mean"] = torch.from_numpy(state[key]["mean"])
            sd[f"{key}.bn.running_var"] = torch.from_numpy(state[key]["var"])
            sd[f"{key}.bn.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[f"{key}.conv.bias"] = torch.from_numpy(p["b"])
    torch.save(sd, tmp_path / "m.pth")
    for (jp, js), (tp, ts) in ((jwio.load_torch_state_dict(jspec, str(tmp_path / "m.pth")),
                                twio.load_torch_state_dict(spec, str(tmp_path / "m.pth"))),
                               (jwio.load_darknet_weights(jspec, str(tmp_path / "j.weights")),
                                twio.load_darknet_weights(spec, str(tmp_path / "j.weights")))):
        for a, b in ((jp, tp), (js, ts)):
            assert a.keys() == b.keys() == (params if a is jp else state).keys()
            for key in a:
                for k in a[key]:
                    np.testing.assert_array_equal(a[key][k], b[key][k])
