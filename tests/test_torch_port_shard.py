"""The port's data-parallel input, serving and CLI pieces, on the CPU.

- loader shards: `BatchIterator._epoch_indices` of 11 samples over 2
  shards, epoch 3, shuffled, equals the JAX loader's (DistributedSampler's
  wrap padding: 6 + 6 with one repeat); the sharded train batches (device
  raster, multiscale on) equal the JAX loader's, batch for batch and key
  for key, with equal lengths and sizes on both shards;
- the batched COO layout: `pack_cells_batched` bit-equal to JAX's (with a
  truncated frame and pad rows); `make_bev_map_from_cells_batched` bit-equal
  to JAX's and to the port's flat raster of the same frames; a
  `cells_batched` val loader's batches equal the JAX loader's;
- `make_inference_fn(devices=[cpu, cpu])` gives the one-device detections on
  a full batch of 8 and on a 5-frame tail (zero-padded to 6, the pad sliced
  off), from points and from batched cells; flat cells with two devices
  raise;
- `parallel`: `make_mesh_for_batch`'s largest dividing prefix,
  `device_prefetch` (order, absent keys skipped, host keys passed through,
  at most `depth` batches read ahead), `initialize_distributed` a no-op at
  world size 1 and its argument checks;
- `cli.train --num_processes 2 --device cpu` (two processes over gloo on a
  synthetic tree of 4 train and 2 val frames, launched and bounded as
  tests/test_multiprocess.py does):
  one epoch with validation; only the lead logs (one log file, one
  TensorBoard file, nothing from rank 1) and checkpoints; the checkpoint
  restores into a 1-process state, which then steps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_yolov4_tpu.data import bev as jbev
from complex_yolov4_tpu.data import loader as jloader
from complex_yolov4_tpu_torch import parallel, train as T
from complex_yolov4_tpu_torch.data import bev, loader as tloader, synthetic
from complex_yolov4_tpu_torch.evaluation import evaluator as tev
from complex_yolov4_tpu_torch.models import weights, zoo
from complex_yolov4_tpu_torch.models.network import Darknet, TrainDarknet

from ._torch_port_util import capped_threads, free_port, run_workers  # noqa: F401
from .test_torch_port_train_data import AUG

NAME = "complex_yolov4_tiny"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate_kitti_dataset(
        str(tmp_path_factory.mktemp("kitti") / "tree"), num_train=8, num_val=6, num_test=0,
        seed=4)


class _StubDataset:
    img_size = 608
    mosaic = False
    aug_transforms = None

    def __len__(self) -> int:
        return 11  # not divisible by 2: the wrap padding


def test_shard_indices_match_jax():
    shards = []
    for s in range(2):
        j = jloader.BatchIterator(_StubDataset(), 2, shuffle=True, shard_id=s, num_shards=2)
        t = tloader.BatchIterator(_StubDataset(), 2, shuffle=True, shard_id=s, num_shards=2)
        j.set_epoch(3)
        t.set_epoch(3)
        np.testing.assert_array_equal(t._epoch_indices(), j._epoch_indices())
        assert len(t) == len(j) == 3
        shards.append(list(t._epoch_indices()))
    assert sorted(set(shards[0] + shards[1])) == list(range(11))
    assert len(shards[0]) == len(shards[1]) == 6
    with pytest.raises(ValueError, match="shard_id"):
        tloader.BatchIterator(_StubDataset(), 2, shard_id=2, num_shards=2)


def test_sharded_train_batches_match_jax(root, monkeypatch):
    from complex_yolov4_tpu import native

    monkeypatch.setattr(native, "is_available", lambda: False)  # the numpy raster
    kw = dict(multiscale=True, seed=3, device_raster=True, **AUG)
    sizes = []
    for s in range(2):
        jl = jloader.create_train_loader(root, 2, shard_id=s, num_shards=2, **kw)
        tl = tloader.create_train_loader(root, 2, shard_id=s, num_shards=2, **kw)
        jl.prefetch = tl.prefetch = 0
        jl.set_epoch(2)
        tl.set_epoch(2)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 2
        for jb, tb in zip(jbs, tbs):
            assert set(jb) == set(tb)
            for k in jb:
                a, b = np.asarray(jb[k]), np.asarray(tb[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        sizes.append([b["size"] for b in tbs])
    assert sizes[0] == sizes[1]  # every rank draws the same multiscale size


def _frames(n, seed=20):
    cells, keys = [], []
    for s in range(n):
        pts = bev.remove_points_outside(synthetic.sample_scene(
            np.random.default_rng(seed + s), clustered=s % 2 == 1)[0])
        c, k = bev.aggregate_bev_cells(pts)
        cells.append(c)
        keys.append(k)
    return cells, keys


def test_batched_cells_match_jax_and_flat():
    cells_l, keys_l = _frames(3)
    cap = max(len(c) for c in cells_l)
    got = bev.pack_cells_batched(cells_l, keys_l, cap, total_frames=4)
    ref = jbev.pack_cells_batched(cells_l, keys_l, cap, total_frames=4)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a frame past the capacity truncates alike
    short = min(len(c) for c in cells_l) - 5
    for a, b in zip(bev.pack_cells_batched(cells_l, keys_l, short),
                    jbev.pack_cells_batched(cells_l, keys_l, short)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="total_frames"):
        bev.pack_cells_batched(cells_l, keys_l, cap, total_frames=2)

    raster = bev.make_bev_map_from_cells_batched(*(torch.from_numpy(x) for x in got))
    jraster = np.asarray(jbev.make_bev_map_from_cells_batched(*(jnp.asarray(x) for x in ref)))
    assert raster.shape == (4, 608, 608, 3) and raster.dtype == torch.float32
    np.testing.assert_array_equal(raster.numpy(), jraster)
    flat = bev.pack_cells_flat(cells_l, keys_l, 4 * cap, total_frames=4)
    np.testing.assert_array_equal(
        raster.numpy(), bev.make_bev_map_from_cells(*(torch.from_numpy(x) for x in flat),
                                                    4).numpy())
    assert not raster[3].any()  # the pad row rasters empty


def test_cells_batched_val_loader_matches_jax(root):
    kw = dict(device_raster=True, cells_raster=True, cells_batched=True, cell_capacity=16384)
    jl = jloader.create_val_loader(root, 4, **kw)
    tl = tloader.create_val_loader(root, 4, **kw)
    jl.prefetch = tl.prefetch = 0
    jbs, tbs = list(jl), list(tl)
    assert len(jbs) == len(tbs) == 2 and tbs[1]["batch"] == 2
    for jb, tb in zip(jbs, tbs):
        assert set(jb) == set(tb) and tb["cells"].shape == (4, 16384)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(tb[k]), err_msg=k)


@pytest.fixture(scope="module")
def served():
    """A folded f32 complex_yolov4_tiny on the CPU and 8 synthetic frames as
    padded points and as batched cells."""
    spec = zoo.get_model_spec(NAME)
    params, state = weights.init_params_np(spec, seed=5)
    model = Darknet(spec, weights.from_jax_params(spec, params, state),
                    compute_dtype=torch.float32, device=CPU)
    clouds = [bev.remove_points_outside(synthetic.sample_scene(np.random.default_rng(30 + s))[0])
              for s in range(8)]
    pts, pmask = zip(*(bev.pad_points(c, 20480) for c in clouds))
    points = (np.stack(pts), np.stack(pmask), np.zeros(8, np.float32),
              np.zeros((8, 1, 5), np.float32), np.zeros((8, 1), np.float32))
    cells_l, keys_l = zip(*(bev.aggregate_bev_cells(c) for c in clouds))
    cap = max(len(c) for c in cells_l)
    return model, points, (cells_l, keys_l, cap)


def _same_detections(got, ref):
    (dg, mg), (dr, mr) = got, ref
    assert dg.shape == dr.shape and torch.equal(mg, mr)
    assert mr.sum() > 0  # live detections
    torch.testing.assert_close(dg[mg > 0.5], dr[mr > 0.5], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("frames", [8, 5], ids=["full", "tail"])
def test_inference_over_two_devices_equals_one(served, frames):
    model, points, (cells_l, keys_l, cap) = served
    kw = dict(conf_thresh=0.5, nms_thresh=0.5, img_size=160)
    one = tev.make_inference_fn(from_points=True, **kw)
    two = tev.make_inference_fn(from_points=True, devices=[CPU, CPU], **kw)
    inputs = [x[:frames] for x in points]
    ref = one(model, *inputs)
    assert ref[0].shape[0] == frames
    _same_detections(two(model, *inputs), ref)

    # batched cells split over the two devices; a flat batch cannot
    two_cells = tev.make_inference_fn(from_cells=True, devices=[CPU, CPU], **kw)
    batched = bev.pack_cells_batched(cells_l[:frames], keys_l[:frames], cap, total_frames=8)
    got = two_cells(model, *batched, frames, 8)
    flat = bev.pack_cells_flat(cells_l[:frames], keys_l[:frames], 8 * cap, total_frames=8)
    _same_detections(got, tev.make_inference_fn(from_cells=True, **kw)(model, *flat, frames, 8))
    with pytest.raises(ValueError, match="batched layout"):
        two_cells(model, *flat, frames, 8)


def test_parallel_helpers():
    devs = [torch.device("cpu")] * 8
    assert len(parallel.make_mesh_for_batch(6, devs)) == 6
    assert len(parallel.make_mesh_for_batch(7, devs)) == 7
    assert len(parallel.make_mesh_for_batch(2, devs[:3])) == 2
    assert len(parallel.make_mesh_for_batch(5, devs[:4])) == 1

    read = []

    def host():
        for i in range(4):
            read.append(i)
            yield {"targets": np.full((2, 3), i, np.float32), "size": 96 + i,
                   "sample_ids": np.arange(2)}

    got = []
    for b in parallel.device_prefetch(host(), "cpu", keys=("image", "targets"),
                                      host_keys=("size",), depth=2):
        got.append(b)
        assert len(read) <= len(got) + 1  # at most `depth` batches ahead
    assert [set(b) for b in got] == [{"targets", "size"}] * 4
    assert [b["size"] for b in got] == [96, 97, 98, 99]
    assert all(isinstance(b["targets"], torch.Tensor) and float(b["targets"][0, 0]) == i
               for i, b in enumerate(got))

    assert parallel.initialize_distributed(None, 1, 0, device="cpu") is False
    assert not parallel.is_distributed()
    assert parallel.local_shard_info()["num_shards"] == 1
    with pytest.raises(ValueError, match="process_id"):
        parallel.initialize_distributed("localhost:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        parallel.initialize_distributed(None, 2, 0, device="cpu")


def test_train_cli_two_processes(tmp_path):
    root = synthetic.generate_kitti_dataset(str(tmp_path / "tree"), num_train=4, num_val=2,
                                            num_test=0, seed=4)
    wd = str(tmp_path / "wd")
    port = free_port()
    argv = ["-m", "complex_yolov4_tpu_torch.cli.train"]
    outs = run_workers(argv, lambda r: [
        "--dataset_dir", root, "--model", NAME, "--batch_size", "2", "--device", "cpu",
        "--working_dir", wd, "--num_epochs", "1", "--subdivisions", "1",
        "--compute_dtype", "float32", "--conf_thresh", "0.3", "--print_freq", "1",
        "--num_processes", "2", "--process_id", str(r),
        "--coordinator_address", f"localhost:{port}"])
    assert "val mAP" in outs[0] and "data parallel: 2 processes" in outs[0], outs[0]
    assert "val mAP" not in outs[1] and "Epoch [" not in outs[1], outs[1]

    logs = os.path.join(wd, "logs", "complexer_yolo")
    log = open(os.path.join(logs, "logger_complexer_yolo.txt")).read()
    assert log.count("training done") == 1 and log.count("val mAP") == 1
    assert log.count("checkpoint save for epoch 1") == 1
    assert sum(f.startswith("events.") for f in os.listdir(logs)) == 1
    ckpts = os.path.join(wd, "checkpoints", "complexer_yolo")
    assert os.listdir(ckpts) == ["epoch_1.ckpt"]

    # the checkpoint restores into a 1-process state, which steps on
    spec = zoo.get_model_spec(NAME)
    model = TrainDarknet(spec, compute_dtype=torch.float32)
    state = T.TrainState(model, T.create_optimizer(model))
    state, epoch = T.restore_checkpoint(os.path.join(ckpts, "epoch_1.ckpt"), state)
    # 4 frames over 2 ranks of batch 2: one micro-batch per rank
    assert epoch == 1 and state.global_step == 1
    loader = tloader.create_train_loader(root, 2, device_raster=True, num_samples=2)
    loader.prefetch = 0
    loader.set_epoch(2)
    metrics = T.make_train_step()(state, next(iter(loader)), 1e-3, 96)
    assert np.isfinite(float(metrics["loss"])) and state.global_step == 2
