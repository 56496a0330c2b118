"""Cells cut to a size the CPU tests can run: the same files, with the
configuration's input size, the batch and the pools made small."""

from __future__ import annotations

from port_bench import harness

SERVE_CELLS = tuple(w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")
                    ["workloads"])


def small_cell(name: str, img_size: int = 128) -> harness.Cell:
    base = harness.Cell(name)
    cfg = dict(base.config, img_size=img_size)
    tr = dict(base.traffic, batch=2, pool_requests=2, calibration_frames=2,
              check_requests=2, coo_capacity=2 * 15360)
    return harness.Cell(name, base.benchmark, workload=base.workload, config=cfg, traffic=tr)


def run_small(cell: harness.Cell, seed: int = 2 ** 31 + 5, seconds: float = 0.3):
    """(checks, numbers) of one run of `cell` on the CPU."""
    import time

    import torch

    result, numbers, _ = cell.generator().run(torch, cell, seed, seconds, False,
                                              time.perf_counter(), dev="cpu")
    return harness.judge(numbers, cell.workload["limits"]), numbers

# input sizes at which a frame's heads differ from another frame's enough
# for the half-batch fault to show, and the CPU runs a cell in tens of seconds
SIZES = {"v4-serve-int8fused-b16": 608, "v4-serve-bf16-b16": 256}
