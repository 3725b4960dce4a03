"""Plain reference of upstream's knurled cylinder (soypat/gsdf
examples/knurled-cylinder/knurled-cyl.go:57-110) at its published
defaults: a cylinder of diameter d = 20 (r = 10) and length 5r, its edges
rounded by 0.1r; less, each smoothly over 0.1r, a diamond knurl (a box of
side r and length 4r, turned 45 deg about z, moved out to 1.6r, repeated 24
times about z, the ring twisted by 0.75 / r one way joined to the same
ring twisted the other way), a bore of diameter r through the length, and
two vents (cylinders of radius r / 4 and length 3r turned onto x) at the
two ends. Built from the recipe alone; the nodes' departures from upstream
are in `torch_bench/reference/knurl.py`.
"""
from __future__ import annotations

import math

from torch_bench.reference import knurl, sdf, text

ORIGINAL: dict = {}


def part(values=None):
    if values:
        raise ValueError(f"the knurled cylinder has no editable dimension, got {sorted(values)}")
    r = 20.0 / 2
    length, bore, side = 5 * r, r, r
    smooth, twist, offset, copies = 0.1 * r, 0.75, 1.6, 24
    body = sdf.Cylinder(r, length, smooth)
    tooth = text.Rotate(knurl.Box(side, side, length * 0.8, 0.0), math.pi / 4, (0, 0, 1))
    ring = knurl.CircularArray(sdf.Translate(tooth, [offset * r, 0, 0]), copies, copies)
    diamond = sdf.Union([knurl.Twist(ring, twist / r), knurl.Twist(ring, -twist / r)])
    obj = knurl.SmoothDifference(smooth, body, diamond)
    obj = knurl.SmoothDifference(smooth, obj, sdf.Cylinder(bore / 2, length + 2 * r, 0.0))
    vent = text.Rotate(sdf.Cylinder(0.25 * r, 3 * r, 0.0), math.pi / 2, (0, 1, 0))
    obj = knurl.SmoothDifference(smooth, obj, sdf.Translate(vent, [0, 0, -length / 2]))
    return knurl.SmoothDifference(smooth, obj, sdf.Translate(vent, [0, 0, length / 2]))
