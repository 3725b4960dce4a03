"""Spans inside the port: where its host time goes, on the profiler's clock.

A span is a named stretch of one layer's host work, opened where the work
happens:

    from gsdf_tpu_torch import spans

    with spans.span("native.decode"):
        ...

Tracing is off unless someone is looking. Off, `span` costs a test of a
module flag and of torch's "is a profiler running" flag, and returns a
shared null context: it records nothing and opens no profiler range. It is
on in two cases:

- a `torch.profiler` session is active in the process. Each span is then
  also a profiler range named `gsdf.<name>`, so any trace of the session
  shows the port's spans beside the device's kernels, copies and memsets,
  and each idle stretch of the device can be put down to the innermost
  `gsdf.*` range over it;
- the caller is inside `recording()`, the operator's way in:

      with spans.recording():
          viewer.render_current("full")
      spans.summary()  # {name: {"count", "total_s", "self_s"}}

When on, each span is kept as a `Record`: its name, its start and end on
`time.perf_counter()`, its sequence number, its parent's (the enclosing
span's, None at a root) and its request's (the root's), so all spans of one
request share it. The store is a ring of the last `RING` spans.

The spans, and what reads them:

- `viewer.frame` (root), `InteractiveViewer.render_current`; also the
  viewer's own frame timing (`frame_stats`), whether tracing is on or not;
- `raymarch.scene`, `visual.raymarch.raymarch_image_device`: the tree walks
  of `auto_relax` and `camera`;
- `launch.<kernel>`, `kernels.launch`: the C entry call of every wrapper;
- `viewer.fetch`: the frame's copy to the host and its wait;
- `flat.render_compact` (root), `compact.fetch` (the compact payload's
  three copies), `mc.count_read` (K3's counts), `native.decode`,
  `params.pack` (a parametric launch's vector), `stl.encode` (root,
  `render.stl.write_binary_stl_indexed`).

The benchmark's traced runs read them (`torch_bench/metrics/_program.py`).

The program's counters stay where they were: `kernels.LAUNCHES`, the
launches of each kernel (the benchmark's check that the profiler lost no
device event), and `_build.COUNTS`, compiler runs and libraries loaded
(the benchmark's `builds`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

#: the spans kept, the newest last; the oldest drop out first
RING = 1 << 17

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_store: collections.deque = collections.deque(maxlen=RING)
_seq = itertools.count()
_local = threading.local()  # .open: the spans open in this thread, innermost last
_recording = 0  # depth of `recording()` contexts, in all threads
_recording_lock = threading.Lock()


class Record(NamedTuple):
    name: str
    start: float  # time.perf_counter()
    end: float
    seq: int
    parent: Optional[int]  # the enclosing span's seq; None at a root
    request: int  # the root's seq


class _Clock:
    """Two clock reads: `timed`'s context when tracing is off."""

    __slots__ = ("start", "seconds")

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


class _Span(_Clock):
    __slots__ = ("name", "seq", "parent", "request", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        self.seq = next(_seq)
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.seq
        self.request = self.seq if up is None else up.request
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function("gsdf." + self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.seconds = end - self.start
        _local.open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _store.append(Record(self.name, self.start, end, self.seq, self.parent, self.request))
        return False


def span(name: str):
    """A context that records the span `name` when tracing is on, and is a
    shared null context when it is off."""
    if not _recording and not _profiler_enabled():
        return _NULL
    return _Span(name)


def timed(name: str):
    """As `span`, for a caller that uses the span's length itself: the
    context's `seconds` holds it after the block, on or off."""
    if not _recording and not _profiler_enabled():
        return _Clock()
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with no profiler running."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def records() -> list:
    """The kept spans, oldest first (a span is kept when it closes, so a
    child comes before its parent)."""
    return list(_store)


def clear() -> None:
    _store.clear()


def summary() -> dict:
    """{name: {"count", "total_s", "self_s"}} over the kept spans; a span's
    self time is its length less its children's."""
    recs = records()
    children = collections.defaultdict(float)
    for r in recs:
        if r.parent is not None:
            children[r.parent] += r.end - r.start
    out: dict = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += r.end - r.start
        s["self_s"] += r.end - r.start - children.get(r.seq, 0.0)
    return out
