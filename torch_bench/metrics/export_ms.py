"""export_ms: the window's length over the exports completed in it, host
clock (one closed-loop client)."""
from torch_bench.stats import per_request_ms


def read(run, qualifier):
    return per_request_ms(run.window_s, run.completed)
