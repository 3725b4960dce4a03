"""fetch_ms.<kind>: the summed `*.fetch` spans per request, ms: the host
waiting for the device's work and its copy to the host (`viewer.fetch` on
the view's frames, `compact.fetch` on the mesh kinds' renders)."""
from torch_bench.metrics._program import per_request_ms


def read(run, qualifier):
    return per_request_ms(run, lambda name: name.endswith(".fetch"))
