"""render_ms.<kind>: the mean of the span around the render call
(`render_compact`) per request of the traced window, ms."""
from torch_bench.metrics._span import mean_ms


def read(run, qualifier):
    return mean_ms(run, "render")
