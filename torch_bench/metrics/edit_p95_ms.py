"""edit_p95_ms: the 95th percentile of edit to mesh in hand over every edit
of the traced window, host clock."""
from torch_bench.stats import percentile


def read(run, qualifier):
    return percentile(run.latencies, 95) * 1e3
