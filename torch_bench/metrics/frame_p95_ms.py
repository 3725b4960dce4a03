"""frame_p95_ms: the 95th percentile of a rest frame up to the fetched image
over every frame in the window, host clock."""
from torch_bench.stats import percentile


def read(run, qualifier):
    return percentile(run.latencies, 95) * 1e3
