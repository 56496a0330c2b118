"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix and metric in it resolves to its files."""

import json
import re

import pytest

from port_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.Cell(name)
    assert cell.entry["chips"] == 1
    assert cell.generator().run
    assert cell.workload["config"] == cell.entry["config"]
    assert cell.workload["traffic"] == cell.entry["traffic"]
    assert cell.workload["limits"]
    reported = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer()


def test_configs_resolve():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = harness.read_json(harness.ROOT / c["file"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    read = harness.metric_reader(metric["name"])
    assert read({}) is None
    assert read({"kind": "neither"}) is None
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)
