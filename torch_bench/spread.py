"""The spread of each metric over sets of runs, to set a bound from.

    python3 torch_bench/spread.py SET_A_1.out SET_A_2.out ... -- SET_B_1.out ...

Each file holds a run's output; its last line is the result. Sets are
separated by `--`. For each metric it prints each set's median and spread
(the distance between the first and the third quartile over the median,
statistics.quantiles' default) over all its runs, the wider of them and
five times it (the bound's rule), and the spread a bound is held to for
tightness: each set's spread with its run farthest from the median left
out, the mean over the sets.
"""
from __future__ import annotations

import json
import statistics
import sys

from stats import spread  # run as a script from torch_bench/


def _last_json(path):
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def _without_farthest(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv) -> int:
    sets, cur = [], []
    for a in argv:
        if a == "--":
            sets.append(cur)
            cur = []
        else:
            cur.append(a)
    sets.append(cur)
    values: dict = {}
    for i, files in enumerate(sets):
        for f in files:
            for name, m in _last_json(f)["metrics"].items():
                values.setdefault(name, [[] for _ in sets])[i].append(m["value"])
    for name, per_set in sorted(values.items()):
        rows = [(statistics.median(v), spread(v)) for v in per_set if len(v) >= 2]
        if not rows:
            continue
        widest = max(s for _, s in rows)
        trimmed = [spread(_without_farthest(v)) for v in per_set if len(v) >= 3]
        tight = f"; tightness {statistics.mean(trimmed):.4f}" if trimmed else ""
        print(f"{name}: " + "; ".join(f"median {m!r} spread {s:.4f}" for m, s in rows)
              + f"; widest {widest:.4f}, x5 {5 * widest:.4f}{tight}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
