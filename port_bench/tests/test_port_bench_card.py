"""On a CUDA card: one short run of each cell through `run.py`, as the
benchmark's checks run it, comes out correct with its metrics and the
device's fields. Skips without a card."""

import json
import subprocess
import sys

import pytest

from port_bench import harness

CELLS = [w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, trace, cuda_card):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name,
                          "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = harness.Cell(name)
    wanted = cell.per_layer() if trace else cell.end_to_end()
    assert {m["name"] for m in wanted} <= set(line["metrics"]) or trace
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
