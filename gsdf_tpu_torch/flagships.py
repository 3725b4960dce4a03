"""The golden parts of the ported slice (gsdf_tpu/flagships.py): the NPT
flange and the fibonacci showerhead, built exactly as the JAX package
builds them, so both packages hash and render the same part."""
from __future__ import annotations

import math

from .core import Builder
from .forge import threads

# Exact golden triangle counts of the compact path; backend-invariant
# (the JAX package's CPU oracle and its TPU render the same counts).
GOLDEN_FLANGE_TRIS = 423852  # resdiv 400
GOLDEN_FLANGE_800_TRIS = 1704568  # resdiv 800
GOLDEN_SHOWERHEAD_TRIS = 309872  # resdiv 350
GOLDEN_BOLT_TRIS = 137528  # resdiv 300 (part not ported yet)
GOLDEN_KNURLED_TRIS = 616324  # resdiv 350 (part not ported yet)


def flange_scene(bld: Builder):
    """Threaded NPT pipe fitting with base plate — the reference's README
    benchmark part (reference examples/npt-flange/flange.go:23-58)."""
    tlen = 18.0 / 25.4
    internal_diameter = 1.5 / 2.0
    flange_h = 7.0 / 25.4
    flange_d = 60.0 / 25.4

    npt = threads.NPT()
    npt.set_from_nominal(1.0 / 2.0)

    pipe = threads.nut(bld, threads.NutParams(thread=npt, style=threads.NutStyle.CIRCULAR))

    # Base plate which goes bolted to joint.
    flange = bld.new_cylinder(flange_d / 2, flange_h, flange_h / 8)
    # Join threaded section with flange.
    flange = bld.translate(flange, 0, 0, -tlen / 2)
    union = bld.smooth_union(0.2, pipe, flange)
    # Make through-hole in flange bottom.
    hole = bld.new_cylinder(internal_diameter / 2, 4 * flange_h, 0)
    union = bld.difference(union, hole)
    # Convert from imperial inches to millimeters.
    return bld.scale(union, 25.4)


def fibonacci(n: int):
    """Fibonacci-spiral point placement (reference
    examples/fibonacci-showerhead/main.go:90-96)."""
    angle_of_divergence = 137.3
    spacing = 2.6
    a = n * angle_of_divergence / 360 * math.pi
    r = spacing * math.sqrt(n)
    return r * math.cos(a), r * math.sin(a)


def showerhead_scene(bld: Builder):
    """Showerhead with plastic buttress thread, knurled grip and 130
    fibonacci-spaced holes (reference
    examples/fibonacci-showerhead/main.go:30-88)."""
    thread_ext_diameter = 65.0
    threaded_length = 5.0
    thread_turns = 3.0
    thread_pitch = threaded_length / thread_turns

    showerhead_base_thick = 2.5
    showerhead_wall = 4.0
    thread_height = 5.0

    shower_thread = threads.PlasticButtress(d=thread_ext_diameter, p=thread_pitch)
    knurled = threads.knurled_head(
        bld, thread_ext_diameter / 2 + showerhead_wall, thread_height, 1
    )
    screw = threads.screw(bld, thread_height + 0.5, shower_thread)
    obj = bld.difference(knurled, screw)

    base = bld.new_cylinder(
        thread_ext_diameter / 2 + showerhead_wall, showerhead_base_thick, 0
    )
    base = bld.translate(
        base, 0, 0, -(threaded_length / 2 + showerhead_base_thick / 2 - 1)
    )

    hole = bld.new_cylinder(0.8, showerhead_base_thick * 10, 0)
    holes = hole
    for i in range(130):
        x, y = fibonacci(i)
        holes = bld.union(holes, bld.translate(hole, x, y, 0))
    base = bld.difference(base, holes)

    return bld.union(obj, base)


def _checked(bld: Builder, obj):
    err = bld.err()
    if err:
        raise err
    return obj


def build_flange():
    bld = Builder()
    return _checked(bld, flange_scene(bld))


def build_showerhead():
    bld = Builder()
    return _checked(bld, showerhead_scene(bld))
