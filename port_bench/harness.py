"""What every cell shares: finding a cell's files by name, the card's
description, the result line, the correctness limits, the reading of a
profiler trace, and the check that nothing of JAX was loaded.

A cell `<name>` is the entry of `BENCHMARK.json` `workloads`; its own
file `workloads/<name>.json` holds its correctness limits; its
configuration is `configs/<config>.json`, its traffic mix
`traffic/<traffic>.json`, which names its generator
`generators/<generator>.py`; each per-layer metric is read by
`metrics/<metric name>.py`'s `read(record)`.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "complex_yolov4_tpu")


class Cell:
    """One cell with its files, resolved by name."""

    def __init__(self, name: str, benchmark: Optional[dict] = None, **files):
        """files: `workload`, `config`, `traffic` dicts in place of the
        files (the tests' small cells)."""
        bench = benchmark or json.loads((ROOT / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.benchmark = bench
        self.workload = files.get("workload") or read_json(HERE / "workloads" / f"{name}.json")
        self.config = files.get("config") or read_json(
            HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = files.get("traffic") or read_json(
            HERE / "traffic" / f"{self.entry['traffic']}.json")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def generator(self):
        return importlib.import_module(f"port_bench.generators.{self.traffic['generator']}")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def metric_reader(name: str):
    """`read(record)` of metrics/<name>.py (a metric name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def layers_of(spec) -> List[dict]:
    """A program `NetSpec`'s layers as the configuration files write them."""
    out = []
    for layer in spec.layers:
        kind = type(layer).__name__
        if kind == "ConvSpec":
            out.append({"type": "conv", "filters": layer.filters, "size": layer.size,
                        "stride": layer.stride, "pad": bool(layer.pad),
                        "bn": bool(layer.batch_normalize), "act": layer.activation})
        elif kind == "MaxPoolSpec":
            out.append({"type": "maxpool", "size": layer.size, "stride": layer.stride})
        elif kind == "RouteSpec":
            out.append({"type": "route", "layers": list(layer.layers), "groups": layer.groups,
                        "group_id": layer.group_id})
        elif kind == "ShortcutSpec":
            out.append({"type": "shortcut", "from": layer.from_index, "act": layer.activation})
        elif kind == "UpsampleSpec":
            out.append({"type": "upsample", "stride": layer.stride})
        elif kind == "YoloSpec":
            out.append({"type": "yolo", "anchors": [list(a) for a in layer.anchors],
                        "num_classes": layer.num_classes, "stride": layer.stride,
                        "scale_x_y": layer.scale_x_y, "ignore_thresh": layer.ignore_thresh})
        else:
            raise ValueError(f"unknown layer {layer!r}")
    return out


class PhaseLog:
    """Prints each phase's seconds since the last and since the start to stderr."""

    def __init__(self, t_begin: float):
        self.t_begin = self.last = t_begin
        self.sums: Dict[str, float] = {}

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[port_bench] {what}: {now - self.last:.2f} s (at {now - self.t_begin:.2f} s)",
              file=sys.stderr, flush=True)
        self.last = now

    def add(self, what: str) -> None:
        """Adds the seconds since the last mark to `what`'s sum."""
        now = time.perf_counter()
        self.sums[what] = self.sums.get(what, 0.0) + now - self.last
        self.last = now

    def totals(self) -> None:
        for what, sec in self.sums.items():
            print(f"[port_bench] {what}: {sec:.2f} s in all", file=sys.stderr, flush=True)


def card(torch, dev) -> dict:
    """The result's `device` fields that need no trace (a CPU run, in the
    tests only, says so and reads no memory)."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def smi(fields: str) -> str:
    """`nvidia-smi --query-gpu=<fields>` of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def power_limit() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    return smi("name,power.limit")


def card_state() -> str:
    """The card's clocks, power draw, temperature and throttle reasons."""
    return (smi("clocks.sm,clocks.mem,power.draw,temperature.gpu") + ", throttle "
            + smi("clocks_throttle_reasons.active"))


def _cpu_ticks() -> List[int]:
    """The machine's CPU ticks by kind (user, nice, system, idle, iowait,
    irq, softirq, steal, ...), or [] where `/proc/stat` cannot be read."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return []


class WindowWatch:
    """What the host and the card did over a measured window, printed to
    stderr and never part of the result: the process's CPU seconds, its
    context switches (involuntary ones mean other work took its core), the
    garbage collections of each generation, the machine's CPU time stolen
    by its hypervisor (`/proc/stat`), and the card's clocks, power,
    temperature and throttle reasons before and after (read outside the
    window)."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.card_before = card_state() if on_card else ""
        self.start = self._now()

    @staticmethod
    def _now():
        use = resource.getrusage(resource.RUSAGE_SELF)
        return (time.process_time(), use.ru_nvcsw, use.ru_nivcsw,
                [g["collections"] for g in gc.get_stats()], _cpu_ticks())

    def report(self, wall_s: float) -> None:
        end = self._now()
        cpu, vol, invol = (b - a for a, b in zip(self.start[:3], end[:3]))
        gcs = "/".join(str(b - a) for a, b in zip(self.start[3], end[3]))
        ticks = [b - a for a, b in zip(self.start[4], end[4])]
        steal = f"{ticks[7] / max(sum(ticks), 1):.4f}" if len(ticks) > 7 else "not read"
        print(f"[port_bench] window host: {cpu:.2f} cpu s of {wall_s:.2f} s, "
              f"{vol} voluntary and {invol} involuntary switches, gc {gcs}, "
              f"steal share {steal}, load {os.getloadavg()[0]:.2f}", file=sys.stderr, flush=True)
        if self.on_card:
            print(f"[port_bench] window card: before {self.card_before}; "
                  f"after {card_state()}", file=sys.stderr, flush=True)


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile of all values, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for each number the cell's file
    gives a limit; a number the run did not give, or one that is not
    finite, fails."""
    out = {}
    for name, limit in limits.items():
        value = float(numbers.get(name, float("nan")))
        ok = math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX package."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def print_result(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers beside their limits as the last lines of
    stderr, then the result as the last line of stdout, with the checks
    under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(line), flush=True)


# -- the profiler's timeline -------------------------------------------------

TRACE_MARK = "port_bench.traced_window"


def _union(spans) -> float:
    """The length of the union of sorted (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def range_busy(events, device_type, prefix: str) -> Dict[str, List[float]]:
    """{name: [device busy seconds inside each host range so named]} for
    every host range whose name starts with `prefix`: the union of the
    device operations that start inside the range. A range that ends on a
    synchronize holds all of its own device work."""
    ranges: Dict[str, List[tuple]] = {}
    dev = []
    for e in events:
        if e.device_type == device_type:
            dev.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(prefix):
            ranges.setdefault(e.name[len(prefix):], []).append(
                (e.time_range.start, e.time_range.end))
    dev.sort()
    starts = [d[0] for d in dev]
    out: Dict[str, List[float]] = {}
    for name, spans in ranges.items():
        for r0, r1 in spans:
            lo, hi = bisect.bisect_left(starts, r0), bisect.bisect_left(starts, r1)
            out.setdefault(name, []).append(
                _union([(s, min(e, r1)) for s, e in dev[lo:hi]]) / 1e6)
    return out


def timeline(events, device_type) -> dict:
    """From the events of a finished `torch.profiler.profile` holding one
    host range named TRACE_MARK: over that range, the device's busy union (s), the range's
    length (s), the device kernels launched in it, the top device ops by
    time and the idle gaps summed by the innermost host op open at each
    gap's start. {} when the profiler saw no device activity."""
    mark = [e for e in events if e.name == TRACE_MARK and e.device_type != device_type]
    if not mark:
        return {}
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    dev, host = [], []
    for e in events:
        rng = e.time_range
        if e.name == TRACE_MARK:
            continue
        if e.device_type == device_type:
            if rng.start >= w0 and rng.start < w1:
                dev.append((rng.start, min(rng.end, w1), e.name))
        elif rng.end > rng.start:
            host.append((rng.start, rng.end, e.name))
    if not dev:
        return {}
    dev.sort()
    busy, gaps = 0.0, [(w0, dev[0][0])]
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    by_op: Dict[str, float] = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    host.sort()
    starts = [h[0] for h in host]
    by_gap: Dict[str, float] = {}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        # the innermost host op open at the gap's start: the latest-starting
        # one that has not ended (looked for among the 4096 before it)
        name = "(host between ops)"
        j = bisect.bisect_right(starts, gs) - 1
        for k in range(j, max(j - 4096, -1), -1):
            if host[k][1] >= gs:
                name = host[k][2]
                break
        by_gap[name] = by_gap.get(name, 0.0) + (ge - gs)
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": len(kernels),
        "device_ops": [[n, t / 1e6] for n, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, t / 1e6] for n, t in sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]],
    }
