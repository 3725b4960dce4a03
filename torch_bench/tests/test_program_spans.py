"""CPU tests of the readers of the program's own spans (`metrics/_program.py`,
`prep_ms`, `launch_ms`, `fetch_ms`, `decode_ms`): synthetic runs whose
program spans and request spans are given, and one view run on the CPU
whose spans the program recorded itself.

    python -m pytest torch_bench/tests -q
"""
from __future__ import annotations

import sys
import time

import pytest

from gsdf_tpu_torch import spans as program
from gsdf_tpu_torch.spans import Record
from torch_bench import harness, kinds, spec
from torch_bench.tests.test_bench import small

MS = 1e-3


def _reader(name):
    mod, qualifier = spec.reader(name)
    return lambda run: mod.read(run, qualifier)


prep, launch, fetch, decode = (_reader(n) for n in
                               ("prep_ms.view", "launch_ms.view", "fetch_ms.view",
                                "decode_ms.export"))


def _frame(seq, t0):
    """A rest frame's program spans from t0 (s): 0.4 ms of host work, a
    0.05 ms launch, then 16 ms waiting for the frame."""
    return [
        Record("raymarch.scene", t0 + 0.1 * MS, t0 + 0.2 * MS, seq + 1, seq, seq),
        Record("launch.raymarch", t0 + 0.35 * MS, t0 + 0.4 * MS, seq + 2, seq, seq),
        Record("viewer.fetch", t0 + 0.42 * MS, t0 + 16.42 * MS, seq + 3, seq, seq),
        Record("viewer.frame", t0, t0 + 16.45 * MS, seq, None, seq),
    ]


def _run(bench_spans, completed):
    run = harness.Run(None, 1, 1.0, True)
    run.spans.done.extend(bench_spans)
    run.completed = completed
    return run


@pytest.fixture
def given(monkeypatch):
    """Set the program's kept spans to a list."""
    def put(recs):
        monkeypatch.setattr(program, "records", lambda: list(recs))
    return put


def test_view_metrics_on_two_frames(given):
    recs = _frame(0, 1.0) + _frame(4, 1.02)
    given(recs)
    run = _run([("frame", 1.0 - MS, 1.0 + 17 * MS), ("frame", 1.02 - MS, 1.02 + 17 * MS)], 2)
    assert prep(run) == pytest.approx(0.4)
    assert launch(run) == pytest.approx(0.05)
    assert fetch(run) == pytest.approx(16.0)
    assert decode(run) is None  # no decode on a view


def test_the_last_launch_ends_the_prep(given):
    recs = _frame(0, 2.0)
    recs.insert(2, Record("launch.box", 2.0 + 0.41 * MS, 2.0 + 0.415 * MS, 9, 0, 0))
    given(recs)
    run = _run([("frame", 2.0, 2.0 + 17 * MS)], 1)
    assert prep(run) == pytest.approx(0.415)
    assert launch(run) == pytest.approx(0.055)


def test_a_retaken_windows_spans_are_left_out(given):
    # a first window lost to the profiler: its frames recorded, its request
    # spans cleared by the harness; the kept window has one frame
    lost = _frame(0, 1.0) + _frame(4, 1.02)
    kept = _frame(8, 5.0)
    kept[2] = kept[2]._replace(end=5.0 + 8.42 * MS)  # an 8 ms fetch
    given(lost + kept)
    run = _run([("frame", 5.0, 5.0 + 17 * MS)], 1)
    assert fetch(run) == pytest.approx(8.0)
    assert prep(run) == pytest.approx(0.4)
    # a span that outlasts its request span is not the request's
    given(lost + [r._replace(end=6.0) if r.name == "viewer.fetch" else r for r in kept])
    assert fetch(run) is None


def test_an_untraced_run_reads_none(given, monkeypatch):
    given([])
    run = _run([("frame", 1.0, 1.1)], 1)
    for read in (prep, launch, fetch, decode):
        assert read(run) is None
    given(_frame(0, 1.0))
    assert all(read(_run([], 0)) is None for read in (prep, launch, fetch, decode))
    # a program without spans (the commit before them)
    monkeypatch.setitem(sys.modules, "gsdf_tpu_torch.spans", None)
    assert all(read(run) is None for read in (prep, launch, fetch, decode))


def test_a_ring_that_dropped_spans_of_the_window_reads_none(given, monkeypatch):
    given(_frame(0, 1.0))
    run = _run([("frame", 0.5, 1.1)], 1)
    assert fetch(run) == pytest.approx(16.0)
    monkeypatch.setattr(program, "RING", 4)  # the ring is full, from after the window began
    assert fetch(run) is None


def test_mesh_requests_read_per_request(given):
    # two exports: a render span and an STL span each; one root render with
    # two fetch-like children, and the STL encode as its own root
    recs = []
    for i, t0 in enumerate((1.0, 1.1)):
        s = 10 * i
        recs += [
            Record("launch.compact_emit", t0 + 1 * MS, t0 + 1.1 * MS, s + 1, s, s),
            Record("compact.fetch", t0 + 2 * MS, t0 + 3 * MS, s + 2, s, s),
            Record("native.decode", t0 + 3 * MS, t0 + 9 * MS, s + 3, s, s),
            Record("flat.render_compact", t0, t0 + 9.5 * MS, s, None, s),
            Record("stl.encode", t0 + 10 * MS, t0 + 17 * MS, s + 4, None, s + 4),
        ]
    given(recs)
    run = _run([("render", 1.0, 1.0 + 9.6 * MS), ("stl", 1.0 + 9.7 * MS, 1.0 + 18 * MS),
                ("render", 1.1, 1.1 + 9.6 * MS), ("stl", 1.1 + 9.7 * MS, 1.1 + 18 * MS)], 2)
    assert decode(run) == pytest.approx(6.0)
    assert _reader("fetch_ms.export")(run) == pytest.approx(1.0)
    assert _reader("prep_ms.export")(run) == pytest.approx(1.1)


def test_a_cpu_view_run_reads_what_the_program_recorded():
    """The view kind's frames on the CPU with the program recording: the
    fetch reads the program's `viewer.fetch`; on the CPU no kernel is
    launched, so the launch and the prep read nothing."""
    cell = small("showerhead350.view")
    part = kinds.program_attr(cell.config["builder"])()
    req = kinds.load("view")(cell, part, "cpu")
    run = harness.Run(cell, 1, 1.0, True)
    program.clear()
    try:
        req.issue({"yaw": 0.3, "pitch": 0.2}, run.spans)  # outside: not counted
        with program.recording():
            req.issue({"yaw": 0.3, "pitch": 0.2}, run.spans)  # a retaken window
            run.spans.clear()
            t = time.perf_counter()
            for yaw in (0.5, 1.5, 2.5):
                req.issue({"yaw": yaw, "pitch": 0.1}, run.spans)
            run.completed = 3
            window = time.perf_counter() - t
        frames = [r for r in program.records() if r.name == "viewer.frame"]
        assert len(frames) == 4
        got = fetch(run)
        mine = [r.end - r.start for r in program.records() if r.name == "viewer.fetch"][1:]
        assert got == pytest.approx(sum(mine) / 3 * 1e3)
        assert 0 < got < window * 1e3 / 3
        assert prep(run) is None and launch(run) is None
    finally:
        program.clear()
