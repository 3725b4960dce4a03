"""prep_ms.<kind>: the mean per request, ms, from the start of the program's
root span (`viewer.frame`, `flat.render_compact`) to the end of its last
`launch.*` span: the host's work up to the last kernel enqueued. In the
view's closed loop the previous frame has been fetched by then, so the
device has nothing to do for the whole stretch."""
from torch_bench.metrics._program import records


def read(run, qualifier):
    recs = records(run)
    if recs is None:
        return None
    starts = {r.request: r.start for r in recs if r.parent is None}
    last: dict = {}
    for r in recs:
        if r.name.startswith("launch.") and r.request in starts:
            last[r.request] = max(r.end, last.get(r.request, r.end))
    if not last:
        return None
    return sum(end - starts[q] for q, end in last.items()) / len(last) * 1e3
