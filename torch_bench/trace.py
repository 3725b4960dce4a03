"""The benchmark's own spans and the reduction of a profiler trace.

Spans are kept in memory: (name, start, end) on the host clock, around
the calls into each layer. In a traced run each span is also a profiler
range (`bench.<name>`), so the trace can say what the host was doing in
each of the device's idle stretches.

`reduce` reads a torch.profiler trace (CUPTI) of one window: the device's
kernels, copies and memsets, their union against the window's length, the
kernels' time by name, and the idle stretches labelled by the innermost
range open on the host over each: a benchmark span or a program span
(`gsdf.<name>`, gsdf_tpu_torch/spans.py).

The profiler can lose device events: a trace then holds the host's launch
calls without the kernels they launched. So each kernel launch call of
the window (a `cuda_runtime` or `cuda_driver` event) has to find its
kernel by the correlation id they share, and the launch calls have to be
at least as many as the program's wrappers launched (each launches one
kernel or more). A trace that fails either has lost events; its device
numbers are not reported.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

from .stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
#: the ranges that label the device's idle stretches: the benchmark's spans
#: and the program's (gsdf_tpu_torch/spans.py), each by its name without
#: the prefix
RANGES = ("bench.", "gsdf.")


def _launches_a_kernel(e: dict) -> bool:
    name = e.get("name", "")
    return e.get("cat") in HOST_API_CATS and ("LaunchKernel" in name
                                              or "LaunchCooperativeKernel" in name)


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


class Spans:
    """Named host-clock spans of one run; with `ranges`, each is also a
    profiler range."""

    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.done: list = []
        self.last: dict = {}  # name: the duration of its latest span

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.ranges:
            import torch

            ctx = torch.profiler.record_function(f"bench.{name}")
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.done.append((name, t0, t1))
                self.last[name] = t1 - t0

    def durations(self, name: str) -> list:
        return [b - a for n, a, b in self.done if n == name]

    def clear(self):
        self.done.clear()
        self.last.clear()


class Trace(NamedTuple):
    window_s: float
    busy_s: float  # union of kernels, copies and memsets inside the window
    kernel_s: float  # kernels' and memsets' summed time inside the window
    kernels: int
    host_launches: int  # kernel launch calls on the host inside the window
    unmatched: int  # of them, those whose kernel the trace does not hold
    lost: bool
    device_ops: list  # [[name, seconds]], most time first, at most 10
    idle_gaps: list  # [[host span, seconds]], most idle time first, at most 10


def reduce(events: list, launches: int) -> Trace:
    """Reduce chrome-trace events of one window; `launches` is what the
    program's own counter says its wrappers launched in it."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows, not 1")
    lo = float(win[0]["ts"]) * 1e-6
    hi = lo + float(win[0]["dur"]) * 1e-6
    dev, by_name, kernels, kernel_s = [], defaultdict(float), 0, 0.0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += b - a
        if e["cat"] == "kernel":
            kernels += 1
        if e["cat"] != "gpu_memcpy":
            kernel_s += b - a
    spans = sorted(
        ((float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6,
          e["name"].split(".", 1)[1])
         for e in xs if e.get("cat") == "user_annotation"
         and e.get("name", "").startswith(RANGES) and e["name"] != WINDOW))
    starts = [s[0] for s in spans]
    longest = max((s[1] - s[0] for s in spans), default=0.0)
    idle = defaultdict(float)
    for a, b in gaps(dev, lo, hi):
        # each stretch of the gap goes to the innermost range open over it (the
        # latest to start; of two that start together, the shorter)
        near = spans[bisect.bisect_left(starts, a - longest):bisect.bisect_left(starts, b)]
        cuts = sorted({a, b, *(t for s in near for t in s[:2] if a < t < b)})
        for c0, c1 in zip(cuts, cuts[1:]):
            mid = (c0 + c1) / 2
            open_ = [s for s in near if s[0] <= mid <= s[1]]
            inner = max(open_, key=lambda s: (s[0], -s[1]), default=None)
            idle[inner[2] if inner else "between requests"] += c1 - c0
    kernel_ids = {_correlation(e) for e in xs if e.get("cat") == "kernel"}
    calls = [e for e in xs if _launches_a_kernel(e) and lo <= float(e["ts"]) * 1e-6 <= hi]
    unmatched = sum(1 for e in calls if _correlation(e) not in kernel_ids)
    lost = kernels == 0 or unmatched > 0 or len(calls) < launches
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Trace(hi - lo, union_length(dev), kernel_s, kernels, len(calls), unmatched, lost,
                 top(by_name), top(idle))


def events_of(prof) -> list:
    """The chrome-trace events of a finished torch.profiler session."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
