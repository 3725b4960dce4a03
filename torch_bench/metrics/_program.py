"""The program's own spans (`gsdf_tpu_torch/spans.py`) inside the run's
requests, for the readers of `<name>_ms.<kind>` metrics that read them.

The program records its spans while a profiler runs, so a traced window's
are there. Only those inside one of the window's own request spans
(`run.spans.done`) count: the harness clears its spans when it takes a
window again, so the spans of a window lost to the profiler drop out. A
program without spans, or a run that recorded none, reads None.
"""
from __future__ import annotations

import bisect
import importlib


def records(run):
    """The program's spans inside the run's request spans, or None."""
    try:
        program = importlib.import_module("gsdf_tpu_torch.spans")
    except ImportError:
        return None
    merged: list = []
    for a, b in sorted((a, b) for _, a, b in run.spans.done):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        return None
    recs = program.records()
    if len(recs) >= program.RING and recs[0].start > merged[0][0]:
        return None  # the ring has dropped spans of this window
    starts = [a for a, _ in merged]
    kept = []
    for r in recs:
        i = bisect.bisect_right(starts, r.start) - 1
        if i >= 0 and r.end <= merged[i][1]:
            kept.append(r)
    return kept or None


def per_request_ms(run, keep):
    """The summed length of the kept spans for which `keep(name)` holds, per
    request completed in the window, ms; None where there are none."""
    recs = records(run)
    if recs is None or not run.completed:
        return None
    picked = [r.end - r.start for r in recs if keep(r.name)]
    return sum(picked) / run.completed * 1e3 if picked else None
