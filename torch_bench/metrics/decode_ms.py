"""decode_ms.<kind>: the summed `native.decode` spans per request, ms: the
native host decode of the compact payload into an indexed mesh."""
from torch_bench.metrics._program import per_request_ms


def read(run, qualifier):
    return per_request_ms(run, lambda name: name == "native.decode")
