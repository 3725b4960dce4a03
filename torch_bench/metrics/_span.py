"""The mean of one benchmark span over the traced window, in ms."""


def mean_ms(run, name):
    d = run.spans.durations(name)
    return sum(d) / len(d) * 1e3 if d else None
