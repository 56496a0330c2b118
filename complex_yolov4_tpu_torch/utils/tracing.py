"""Spans and counters of the serving entry, off unless a `recording()` is open.

    from complex_yolov4_tpu_torch.utils import tracing

    with tracing.recording() as rec:
        infer(model, ...)
    print(rec.summary())

`span(name)` marks a layer of a call: on, it opens
`torch.profiler.record_function("cyv4." + name)`, so that under a running
`torch.profiler` the span is a range of the same trace as the card's
kernels, on the same clock, and it appends a `Span` to the recording. A span
opened with no span open on its thread starts a new request; the spans
inside it share its request id. `count(name, n)` adds `n` to a counter of
the open request (a count made with no span open is not kept). Off, `span`
returns one shared no-op context after one check of a module-level
reference, and `count` returns at once. Under `torch.compile` or
`torch.export` both do nothing, so a traced graph holds no profiler op.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

PREFIX = "cyv4."
_OFF = contextlib.nullcontext()
_active: Optional["Recording"] = None  # the open recording, if any
_opening = threading.Lock()


@dataclass
class Span:
    """One span: host times from `time.perf_counter_ns()`; `parent` is the
    index of the enclosing span in `Recording.spans` (-1 for a request's
    root); `end_ns` is 0 while the span is open."""
    name: str
    request: int
    parent: int
    start_ns: int
    end_ns: int = 0


class Recording:
    """What one `recording()` block recorded: `spans` in the order they
    opened, and `counters`, {request id: {counter name: total}} for every
    request that opened ({} where it counted nothing)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[int, Dict[str, int]] = {}
        self._requests = itertools.count()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def summary(self) -> dict:
        """{"spans": {name: {"calls", "mean_ms", "p95_ms"}} on the host
        clock, "counters": {name: mean per request}, "requests": n}."""
        ms: Dict[str, List[float]] = {}
        for s in self.spans:
            if s.end_ns:
                ms.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
        names = {c for per in self.counters.values() for c in per}
        n = len(self.counters)
        return {
            "spans": {k: {"calls": len(v), "mean_ms": float(np.mean(v)),
                          "p95_ms": float(np.percentile(v, 95))} for k, v in ms.items()},
            "counters": {c: sum(per.get(c, 0) for per in self.counters.values()) / n
                         for c in sorted(names)},
            "requests": n,
        }


class _On:
    """A span while a recording is open."""

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        if stack:
            parent = stack[-1]
            request = rec.spans[parent].request
        else:
            parent, request = -1, next(rec._requests)
            rec.counters[request] = {}
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.index = len(rec.spans)
        rec.spans.append(Span(self.name, request, parent, time.perf_counter_ns()))
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.index].end_ns = time.perf_counter_ns()
        self.rec._stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the layer `name` while a recording
    is open, and does nothing otherwise."""
    rec = _active
    if rec is None or torch.compiler.is_compiling():
        return _OFF
    return _On(rec, name)


def is_recording() -> bool:
    """Whether a recording is open."""
    return _active is not None


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` of the open request, if tracing is on."""
    rec = _active
    if rec is None or torch.compiler.is_compiling():
        return
    stack = rec._stack()
    if stack:
        per = rec.counters[rec.spans[stack[-1]].request]
        per[name] = per.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turns tracing on for the block and yields its `Recording`; tracing
    is off again when the block exits. One recording at a time."""
    global _active
    rec = Recording()
    with _opening:
        if _active is not None:
            raise RuntimeError("a tracing recording is already open")
        _active = rec
    try:
        yield rec
    finally:
        _active = None
