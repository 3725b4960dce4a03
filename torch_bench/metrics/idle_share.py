"""idle_share.<kind>: 1 - (the union of the device's kernel, copy and memset
intervals / the traced window), %. Nothing where the profiler lost events."""


def read(run, qualifier):
    t = run.trace
    if t is None or t.lost or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
