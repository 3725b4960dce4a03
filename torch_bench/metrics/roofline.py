"""roofline.<kind>: the bound of the work the window's requests need (the
request kind counts it, by torch_bench/bounds.py), over the device time of
their kernels and memsets in the traced window, %. Nothing where the
profiler lost events or the work is not known."""


def read(run, qualifier):
    t = run.trace
    if t is None or t.lost or t.kernel_s <= 0 or run.device_bound_s is None:
        return None
    return 100.0 * run.device_bound_s / t.kernel_s
