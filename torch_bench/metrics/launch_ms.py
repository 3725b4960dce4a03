"""launch_ms.<kind>: the summed `launch.*` spans per request, ms: each
wrapper's C entry call (on the view's frame, the memset, K8 and the box
filter enqueued)."""
from torch_bench.metrics._program import per_request_ms


def read(run, qualifier):
    return per_request_ms(run, lambda name: name.startswith("launch."))
