"""The serving entry's own spans on the profiler's clock: where the card's
idle time falls (raster, network, NMS, or outside every layer span), and
how long an answer waits on the NMS once the network's work is done.

The port's `utils/tracing.py` opens `cyv4.serve` around each call of the
serving entry and `cyv4.raster`, `cyv4.network`, `cyv4.nms` inside it, as
`torch.profiler.record_function` ranges, while a `tracing.recording()` is
open; it counts the NMS's rounds per request (`nms.rounds`).

The spans pass is one pass over the pool served as in the window with
tracing on, under the profiler, inside a host range SPANS_MARK, in a
recording of its own after a warm one, so that its counters hold its own
requests. `record_of` turns it into a --trace 1 record's
`record["spans_pass"]`, which nine readers read, `metrics/<name>.py`,
listed in `METRICS`; on a record without it (a port without
`utils/tracing.py` gives none) they return None. Until the generator's
`trace_record` runs it, `python3 -m port_bench.spans --workload <cell>
--seed <n>` (on a CUDA card, from the root of a checkout) runs it after
the cell's set-up and prints one JSON line: the nine readings, each spans
pass's cost against a pass with tracing off under the same profiler, an
unprofiled A/B of tracing on against off on the host clock, and the host
cost of one span and of one count.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional

from port_bench import harness

SPANS_MARK = "port_bench.traced_spans"
PREFIX = "cyv4."
LAYERS = ("raster", "network", "nms")
METRICS = ("raster_span_ms.serve", "network_span_ms.serve", "network_dispatch_ms.serve",
           "nms_tail_ms.serve", "nms_rounds_per_request.serve", "idle_in_raster_share.serve",
           "idle_in_network_share.serve", "idle_in_nms_share.serve",
           "idle_outside_layers_share.serve")


def tracing_module():
    """The port's `utils.tracing`, or None where the port has none."""
    try:
        return importlib.import_module("complex_yolov4_tpu_torch.utils.tracing")
    except ModuleNotFoundError:
        return None


def _enclosing(event, prefix: str):
    """(innermost `prefix` range holding `event` or `event` itself, the
    `serve` range holding it), following `cpu_parent`; None where absent."""
    inner = serve = None
    while event is not None:
        if event.name.startswith(prefix):
            if inner is None:
                inner = event
            if event.name == prefix + "serve":
                serve = event
                break
        event = event.cpu_parent
    return inner, serve


def span_timeline(events, device_type, mark: str = SPANS_MARK,
                  prefix: str = PREFIX) -> dict:
    """From the events of a finished `torch.profiler.profile` holding one
    host range `mark`, over that range: the device's busy union and the
    range's length (s); the requests (`prefix + "serve"` ranges); per
    layer (`raster`, `network`, `nms`, and `outside` for no layer range)
    the device busy union of the ops launched inside it (s), the host
    seconds of its ranges, and the idle seconds of the card while the host
    was in it; and per request the end of the last device op launched in
    its network range and the end of its last NMS range (s from the
    range's start). A device op belongs to the innermost `prefix` range
    that holds the CUDA call that launched it, not to the range open while
    it ran: the profiler gives a kernel or copy the `id` of the CUDA API
    call that launched it (the CUPTI correlation id; a host op's own id
    may be the same number, so the call is the host event of that id
    whose name starts with "cu"), and the call's `cpu_parent` chain leads
    to the range (`outside` where no call is found: `unlinked_device_ops`
    counts them). An idle gap goes to the innermost layer range open on
    the host at the gap's start. {} without the mark or without device
    ops in it."""
    marks = [e for e in events if e.name == mark and e.device_type != device_type]
    if not marks:
        return {}
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    launcher = {}
    ranges = []
    dev = []
    for e in events:
        rng = e.time_range
        if e.device_type == device_type:
            if (rng.start >= w0 and rng.start < w1 and e.name != mark
                    and not e.name.startswith(prefix)
                    and not getattr(e, "is_user_annotation", False)):
                dev.append(e)
            continue
        if e.name.startswith("cu"):
            launcher[e.id] = e
        if e.name.startswith(prefix) and rng.start >= w0 and rng.start < w1:
            ranges.append(e)
    if not dev:
        return {}
    serves = sorted((r for r in ranges if r.name == prefix + "serve"),
                    key=lambda r: r.time_range.start)
    request_of = {id(s): i for i, s in enumerate(serves)}
    layer_names = LAYERS + ("outside",)
    by_layer: Dict[str, list] = {k: [] for k in layer_names}
    net_end: List[Optional[float]] = [None] * len(serves)
    unlinked = 0
    for d in dev:
        start, end = d.time_range.start, min(d.time_range.end, w1)
        host = launcher.get(d.id)
        unlinked += host is None
        inner, serve = _enclosing(host, prefix)
        layer = inner.name[len(prefix):] if inner is not None else "outside"
        layer = layer if layer in LAYERS else "outside"
        by_layer[layer].append((start, end))
        if layer == "network" and serve is not None and id(serve) in request_of:
            i = request_of[id(serve)]
            net_end[i] = end if net_end[i] is None else max(net_end[i], end)
    nms_end: List[Optional[float]] = [None] * len(serves)
    host_s = {k: 0.0 for k in LAYERS}
    layer_ranges = []
    for r in ranges:
        name = r.name[len(prefix):]
        if name not in LAYERS:
            continue
        host_s[name] += r.time_range.end - r.time_range.start
        layer_ranges.append((r.time_range.start, r.time_range.end, name))
        _, serve = _enclosing(r.cpu_parent, prefix)
        if name == "nms" and serve is not None and id(serve) in request_of:
            i = request_of[id(serve)]
            end = r.time_range.end
            nms_end[i] = end if nms_end[i] is None else max(nms_end[i], end)
    spans = sorted((d.time_range.start, min(d.time_range.end, w1)) for d in dev)
    busy, gaps = 0.0, [(w0, spans[0][0])]
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    layer_ranges.sort()
    idle = {k: 0.0 for k in layer_names}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        # the innermost layer range open at the gap's start: the latest-
        # starting one that holds it (layer ranges of one thread nest in
        # `serve` and never in each other)
        name = "outside"
        for s, e, n in layer_ranges:
            if s > gs:
                break
            if e > gs:
                name = n
        idle[name] += ge - gs
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "requests": len(serves),
        "device_s": {k: harness._union(sorted(v)) / 1e6 for k, v in by_layer.items()},
        "host_s": {k: v / 1e6 for k, v in host_s.items()},
        "idle_s": {k: v / 1e6 for k, v in idle.items()},
        "unlinked_device_ops": unlinked,
        "request_ends_s": [[(n - w0) / 1e6, (m - w0) / 1e6]
                           for n, m in zip(net_end, nms_end) if n is not None and m is not None],
    }


def record_of(events, device_type, rec, mark: str = SPANS_MARK) -> dict:
    """The `spans_pass` entry of a --trace 1 record: `span_timeline` of the
    profiler's events and the marked recording's counters, {name: [total
    per request]} ({} where the profiler saw no device op in the pass)."""
    out = span_timeline(events, device_type, mark)
    if not out:
        return {}
    names = sorted({c for per in rec.counters.values() for c in per})
    out["counters"] = {c: [per.get(c, 0) for _, per in sorted(rec.counters.items())]
                       for c in names}
    return out


def spans_pass(record: dict) -> Optional[dict]:
    """A serve record's spans pass with its requests, or None (the readers'
    common test)."""
    if record.get("kind") != "serve":
        return None
    sp = record.get("spans_pass") or {}
    return sp if sp.get("requests") and sp.get("window_s") else None


def idle_share(record: dict, layer: str) -> Optional[float]:
    """% of the spans pass's wall time in which the card idled while the
    host was in `layer` (or, for `outside`, in no layer span)."""
    sp = spans_pass(record)
    return None if sp is None else 100.0 * sp["idle_s"][layer] / sp["window_s"]


def per_request_ms(record: dict, kind: str, layer: str) -> Optional[float]:
    """`device_s` or `host_s` of `layer` in ms per request."""
    sp = spans_pass(record)
    return None if sp is None else sp[kind][layer] * 1e3 / sp["requests"]


def measure(torch, cell, seed: int, reps: int, dev) -> dict:
    """The cell's set-up as `run.py`'s, then `reps` unprofiled A/B
    repetitions of tracing off against on (2 passes over the pool a side),
    then under one profiler `reps` pairs of a pass with tracing off (the
    first inside harness.TRACE_MARK, as the generator's traced pass) and a
    spans pass, each in a mark of its own, the order alternating, and last
    the host cost of one span and one count; returns the line `main`
    prints: the nine readings of each spans pass and their medians, each
    side's ms per request, and the spans' host ms of a spans pass and of
    the last unprofiled recording."""
    import gc
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench.generators import serve_closed_loop as g

    tracing = tracing_module()
    inputs = g.Inputs(cell.traffic, seed)
    folded = g.make_weights(torch, cell.config, seed, inputs, dev)
    server = g.ProgramServer(torch, g.build_program(torch, cell.config, cell.traffic, folded,
                                                    inputs, dev), inputs, cell.traffic)
    pool = [int(r) for r in inputs.order]

    def one_pass() -> float:
        t0 = time.perf_counter()
        for r in pool:
            server.serve(r)
        g.sync(torch, dev)
        return time.perf_counter() - t0

    one_pass()
    with tracing.recording():  # the traced path's first calls
        one_pass()
    gc.collect()
    gc.freeze()
    orders = [("off", "on") if rep % 2 == 0 else ("on", "off") for rep in range(reps)]
    ab = {"off": [], "on": []}
    for order in orders:
        for side in order:
            if side == "on":
                with tracing.recording() as unprofiled:
                    secs = one_pass() + one_pass()
            else:
                secs = one_pass() + one_pass()
            ab[side].append(secs * 1e3 / (2 * len(pool)))
    marks = {"off": [harness.TRACE_MARK] + [f"{harness.TRACE_MARK}.{i}" for i in range(1, reps)],
             "on": [SPANS_MARK] + [f"{SPANS_MARK}.{i}" for i in range(1, reps)]}
    recs = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        one_pass()
        with tracing.recording():
            one_pass()
        for rep, order in enumerate(orders):
            for side in order:
                if side == "on":
                    with tracing.recording() as rec:
                        with record_function(marks["on"][rep]):
                            one_pass()
                    recs.append(rec)
                else:
                    with record_function(marks["off"][rep]):
                        one_pass()
    n = 20000
    with tracing.recording():
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("cost"):
                pass
        t1 = time.perf_counter()
        with tracing.span("cost"):
            for _ in range(n):
                tracing.count("cost")
        t2 = time.perf_counter()
    gc.unfreeze()
    server.close()
    events = prof.events()
    walls = {side: [e.time_range.end - e.time_range.start for m in names for e in events
                    if e.name == m and e.device_type != DeviceType.CUDA]
             for side, names in marks.items()}
    off = harness.timeline(events, DeviceType.CUDA)
    passes = [record_of(events, DeviceType.CUDA, rec, mark) for rec, mark in zip(recs, marks["on"])]
    readings = [{m: harness.metric_reader(m)({"kind": "serve", "spans_pass": sp})
                 for m in METRICS} for sp in passes]
    sp = passes[0]
    return {
        "workload": cell.name, "seed": seed,
        "metrics": {m: statistics.median(r[m] for r in readings)
                    if all(r[m] is not None for r in readings) else None for m in METRICS},
        "metrics_each_pass": readings,
        "spans_pass_idle_share": [100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p else None
                                  for p in passes],
        "idle_shares_sum": [sum(v for m, v in r.items() if m.startswith("idle_") and v is not None)
                            for r in readings],
        "profiled_ms_per_request": {k: [w / 1e3 / len(pool) for w in v]
                                    for k, v in walls.items()},
        "profiled_idle_share_off": 100.0 * (1.0 - off["busy_s"] / off["window_s"]) if off else None,
        "unprofiled_ms_per_request": ab,
        "unprofiled_median_ms": {k: statistics.median(v) for k, v in ab.items()},
        "span_us": (t1 - t0) * 1e6 / n, "count_us": (t2 - t1) * 1e6 / n,
        "summary": recs[0].summary(),
        "summary_unprofiled": unprofiled.summary(),
        "spans_pass": {k: v for k, v in sp.items() if k != "request_ends_s"},
    }


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from port_bench.run import cache_dirs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=3, help="A/B repetitions of 2 passes a side")
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or tracing_module() is None:
        print(f"port_bench.spans: needs a CUDA card and the port's tracing; cuda "
              f"{torch.cuda.is_available()}, tracing {tracing_module() is not None}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(2)  # as run.py
    line = measure(torch, harness.Cell(args.workload), args.seed, args.reps,
                   torch.device("cuda", 0))
    line.update(card=harness.power_limit(), torch=torch.__version__)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
