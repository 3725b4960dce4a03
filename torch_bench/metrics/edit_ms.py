"""edit_ms: the window's length over the edits completed in it, host clock
(one closed-loop client): edit to mesh in hand, all the work over all the
time."""
from torch_bench.stats import per_request_ms


def read(run, qualifier):
    return per_request_ms(run.window_s, run.completed)
