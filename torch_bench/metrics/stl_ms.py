"""stl_ms.<kind>: the mean of the span around `write_binary_stl_indexed` per
export of the traced window, ms."""
from torch_bench.metrics._span import mean_ms


def read(run, qualifier):
    return mean_ms(run, "stl")
