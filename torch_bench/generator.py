"""The one traffic generator: it reads a mix's `draws` and yields the
parameters of each request a closed-loop client sends, from the seed.

A draw is one of

- `{"uniform": [lo, hi], "strata": n}`: a number uniform in [lo, hi];
- `{"one_of": key}`: one entry of the configuration's list `key`.

Requests come in blocks. A block holds every combination of the draws'
strata (a `one_of` has one stratum per entry) once, each number uniform
within its stratum, in a seeded order. So every seed sends the same
distribution of work in another order, and a draw's marginal is uniform
over its range. A mix with no draws sends the same request every time.
"""
from __future__ import annotations

import itertools

import numpy as np


def _strata(draw: dict, config: dict):
    if "one_of" in draw:
        return [("entry", e) for e in config[draw["one_of"]]]
    lo, hi = (float(x) for x in draw["uniform"])
    n = int(draw.get("strata", 1))
    return [("uniform", (lo + (hi - lo) * i / n, (hi - lo) / n)) for i in range(n)]


def requests(mix: dict, config: dict, seed: int):
    """Yield the parameters ({draw name: value}) of each request, forever."""
    draws = mix.get("draws", {})
    names = sorted(draws)
    cells = list(itertools.product(*(_strata(draws[n], config) for n in names)))
    rng = np.random.default_rng(seed)
    while True:
        for k in rng.permutation(len(cells)):
            out = {}
            for name, (kind, v) in zip(names, cells[k]):
                out[name] = v if kind == "entry" else v[0] + v[1] * float(rng.random())
            yield out
