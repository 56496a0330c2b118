"""The control, the reference one precision down put in the program's
place (fp8 for bf16 convs, int4 for int8 convs, the NMS on bf16-rounded
rows), comes out not correct under each serving cell's limits: here on
the CPU at a small size. `limits.py` reads it on the card at the cell's
own size."""

import pytest
import torch

from port_bench import harness
from port_bench.tests._small import SERVE_CELLS, SIZES, small_cell


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = small_cell(name, img_size=SIZES[name])
    readings = list(cell.generator().limit_readings(torch, cell, [], [2 ** 31 + 17], 0.3,
                                                    dev="cpu"))
    assert [who for who, _, _ in readings] == ["control"]
    checks = harness.judge(readings[0][2], cell.workload["limits"])
    assert not all(c["ok"] for c in checks.values()), readings[0][2]
