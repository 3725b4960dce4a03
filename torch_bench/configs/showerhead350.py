"""Plain reference of the fibonacci showerhead (soypat/gsdf
examples/fibonacci-showerhead/main.go:30-88): a knurled head (a rounded
cylinder joined to the intersection of a left and a right 229-start knurl
screw) cut by a plastic buttress thread, joined to a base plate with 130
holes on a fibonacci spiral. Built from the published dimensions alone.
"""
from __future__ import annotations

import math

import numpy as np

from torch_bench.reference import sdf

_f32 = np.float32

ORIGINAL: dict = {}


def fibonacci(n: int):
    """Hole n of the spiral (main.go:90-96)."""
    a = n * 137.3 / 360 * math.pi
    r = 2.6 * math.sqrt(n)
    return r * math.cos(a), r * math.sin(a)


def buttress_profile(d: float, p: float) -> np.ndarray:
    """One pitch of the plastic buttress thread (plasticbuttress.go:9-53)."""
    radius = d / 2
    t0, t1 = 1.0, 0.1227845609029046  # tan(45 deg), tan(7 deg)
    h0 = p / (t0 + t1)
    h1 = 0.6 / 2.0 * p + 0.5 * h0
    hp = p / 2.0
    return sdf.polygon_vertices([
        (p, 0), (p, radius),
        (hp - (h0 - h1) * t1, radius, 0.05 * p, 5),
        (t0 * h0 - hp, radius - h1, 0.15 * p, 5),
        ((h0 - h1) * t0 - hp, radius, 0.15 * p, 5),
        (-p, radius), (-p, 0),
    ])


def knurled_head(radius: float, height: float, pitch: float):
    """A rounded cylinder joined to a diamond knurl (knurl.go:52-101)."""
    rounding = radius * 0.05
    length = pitch * math.floor((height - rounding) / pitch)
    knurl_h = pitch * 0.3
    tan45 = _f32(math.tan(float(_f32(45.0 * math.pi / 180))))
    starts = int(_f32(_f32(_f32(_f32(2 * math.pi) * _f32(radius)) * tan45) / _f32(pitch)))
    profile = sdf.Polygon(np.array([(pitch / 2, 0), (pitch / 2, radius), (0, radius + knurl_h),
                                    (-pitch / 2, radius), (-pitch / 2, 0)], _f32))
    knurl = sdf.Intersection(sdf.Screw(profile, pitch, -pitch * starts, length / 2),
                             sdf.Screw(profile, pitch, pitch * starts, length / 2))
    return sdf.Union([sdf.Cylinder(radius, height, rounding), knurl])


def part(values=None):
    if values:
        raise ValueError(f"the showerhead has no editable dimension, got {sorted(values)}")
    d, pitch, wall, base_thick, thread_h = 65.0, 5.0 / 3.0, 4.0, 2.5, 5.0
    screw = sdf.Screw(sdf.Polygon(buttress_profile(d, pitch)), pitch, -pitch,
                      (thread_h + 0.5) / 2)
    head = sdf.Difference(knurled_head(d / 2 + wall, thread_h, 1), screw)
    base = sdf.Translate(sdf.Cylinder(d / 2 + wall, base_thick, 0),
                         [0, 0, -(5.0 / 2 + base_thick / 2 - 1)])
    hole = sdf.Cylinder(0.8, base_thick * 10, 0)
    holes = sdf.Union([hole], copies=[(hole, [(*fibonacci(i), 0) for i in range(130)])])
    return sdf.Union([head, sdf.Difference(base, holes)])
