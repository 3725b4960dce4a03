"""rebind_ms.<kind>: the mean of the span around `rebind` per edit of the
traced window, ms."""
from torch_bench.metrics._span import mean_ms


def read(run, qualifier):
    return mean_ms(run, "rebind")
