"""The four golden parts (gsdf_tpu/flagships.py), built exactly as the JAX
package builds them, so both packages hash and render the same part:

- NPT flange          (reference examples/npt-flange/flange.go:23-58)
- fibonacci showerhead (reference examples/fibonacci-showerhead/main.go:30-88)
- ISO M3 bolt          (reference examples/bolt/main.go:27-40)
- knurled cylinder     (reference examples/knurled-cylinder/knurled-cyl.go:57-110)

the GEB sculpture of the ui-geb viewer (reference
examples/ui-geb/uigeb.go:22-89), which the benchmark's viewer cell renders,

and the 2D scenes that the example programs render to PNG:

- the plant pot's revolved profile (reference examples/plantpot/main.go:33-64)
- the mandala                       (reference examples/ui-mandala/mandala.go:12-31)
- the showerhead's thread profile   (`showerhead_thread_profile`)
"""
from __future__ import annotations

import math

import numpy as np

from .core import Builder
from .forge import threads
from .geometry.polygon import PolygonBuilder

# Exact golden triangle counts of the compact path; backend-invariant
# (the JAX package's CPU oracle and its TPU render the same counts; the
# bolt and knurled counts are the CPU oracle's, gsdf_tpu/flagships.py:25-30).
GOLDEN_FLANGE_TRIS = 423852  # resdiv 400
GOLDEN_FLANGE_800_TRIS = 1704568  # resdiv 800
GOLDEN_FLANGE_1000_TRIS = 2660772  # resdiv 1000 (tests/test_golden_scale.py:29)
GOLDEN_SHOWERHEAD_TRIS = 309872  # resdiv 350
GOLDEN_BOLT_TRIS = 137528  # resdiv 300
GOLDEN_KNURLED_TRIS = 616324  # resdiv 350


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


def showerhead_scene(bld: Builder, thread_png=None):
    """Showerhead with plastic buttress thread, knurled grip and 130
    fibonacci-spaced holes (reference
    examples/fibonacci-showerhead/main.go:30-88). `thread_png` names a file
    to render the thread's 2D profile into, 512 x 512."""
    thread_ext_diameter = 65.0
    threaded_length = 5.0
    thread_turns = 3.0
    thread_pitch = threaded_length / thread_turns

    showerhead_base_thick = 2.5
    showerhead_wall = 4.0
    thread_height = 5.0

    shower_thread = threads.PlasticButtress(d=thread_ext_diameter, p=thread_pitch)
    if thread_png:
        from .pipeline import render_png_file_2d

        render_png_file_2d(thread_png, shower_thread.thread(bld), 512, 512)

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


def bolt_scene(bld: Builder):
    """M3 ISO bolt with hex head (reference examples/bolt/main.go:27-40)."""
    L, shank = 8, 3
    threader = threads.ISO(d=3, p=0.5, ext=True)
    m3 = threads.bolt(
        bld,
        threads.BoltParams(
            thread=threader,
            style=threads.NutStyle.HEX,
            total_length=L + shank,
            shank_length=shank,
        ),
    )
    return bld.rotate(m3, 2.5 * math.pi / 2, (1, 0, 0.1))


def knurled_scene(bld: Builder, diameter=20.0, hole_diam=0.0, length=0.0,
                  knurl_size=0.0):
    """Knurled cylinder with twisted diamond pattern and vent holes
    (reference examples/knurled-cylinder/knurled-cyl.go:57-110)."""
    r = diameter / 2
    length = length or 5 * r
    hole_diam = hole_diam or r
    knurl_side = knurl_size or r

    smooth_ratio = 0.1
    twist_k = 0.75
    knurl_offset_r = 1.6
    knurl_n = 24

    sk = smooth_ratio * r

    obj = bld.new_cylinder(r, length, smooth_ratio * r)

    knurl_box = bld.new_box(knurl_side, knurl_side, length * 0.8, 0)
    knurl_box = bld.rotate(knurl_box, math.pi / 4, (0, 0, 1))
    knurl_box = bld.translate(knurl_box, knurl_offset_r * r, 0, 0)
    knurl_box = bld.circular_array(knurl_box, knurl_n, knurl_n)
    knurl = bld.union(
        bld.twist(knurl_box, twist_k / r),
        bld.twist(knurl_box, -twist_k / r),
    )
    obj = bld.smooth_difference(sk, obj, knurl)

    obj = bld.smooth_difference(sk, obj, bld.new_cylinder(hole_diam / 2, length + 2 * r, 0))

    vent = bld.new_cylinder(0.25 * r, 3 * r, 0)
    vent = bld.rotate(vent, math.pi / 2, (0, 1, 0))
    obj = bld.smooth_difference(sk, obj, bld.translate(vent, 0, 0, -length / 2))
    return bld.smooth_difference(sk, obj, bld.translate(vent, 0, 0, length / 2))


def _scaling_mat4(sx, sy, sz):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def geb_scene(bld: Builder):
    """The GEB cover sculpture: the glyphs G, E and B extruded, scaled to a
    square section and intersected at right angles, two ways (reference
    examples/ui-geb/uigeb.go:22-89). The font is the port's embedded one;
    textsdf is imported here, not with this module."""
    from .forge.textsdf import Font, FontConfig

    f = Font()
    f.configure(FontConfig(relative_glyph_tolerance=0.01, builder=bld))
    f.load_default()
    G = f.glyph("G")
    E = f.glyph("E")
    B = f.glyph("B")

    szG = G.bounds().size()
    szE = E.bounds().size()
    szB = B.bounds().size()

    # center letters
    G = bld.translate2d(G, -float(G.bounds().min[0]) - szG[0] / 2,
                        -float(G.bounds().min[1]) - szG[1] / 2)
    E = bld.translate2d(E, -float(E.bounds().min[0]) - szE[0] / 2,
                        -float(E.bounds().min[1]) - szE[1] / 2)
    B = bld.translate2d(B, -float(B.bounds().min[0]) - szB[0] / 2,
                        -float(B.bounds().min[1]) - szB[1] / 2)
    round1 = 0.01
    G = bld.offset2d(G, -round1)
    E = bld.offset2d(E, -round1)
    B = bld.offset2d(B, -round1)

    szz = float(max(szG.max(), szE.max(), szB.max()))
    sclG = (szz / szG[0], szz / szG[1])
    sclE = (szz / szE[0], szz / szE[1])
    sclB = (szz / szB[0], szz / szB[1])

    L = szz
    G3 = bld.extrude(G, L)
    E3 = bld.extrude(E, L)
    B3 = bld.extrude(B, L)

    G3 = bld.transform(G3, _scaling_mat4(sclG[0], sclG[1], 1))
    E3 = bld.transform(E3, _scaling_mat4(sclE[0], sclE[1], 1))
    B3 = bld.transform(B3, _scaling_mat4(sclB[0], sclB[1], 1))

    round2 = 0.025
    G3 = bld.offset(G3, -round2)
    E3 = bld.offset(E3, -round2)
    B3 = bld.offset(B3, -round2)

    deg90 = math.pi / 2
    GEB1 = bld.intersection(G3, bld.rotate(E3, deg90, (0, 1, 0)))
    GEB1 = bld.intersection(GEB1, bld.rotate(B3, -deg90, (1, 0, 0)))

    GEB2 = bld.intersection(E3, bld.rotate(G3, deg90, (0, 1, 0)))
    GEB2 = bld.intersection(GEB2, bld.rotate(B3, -deg90, (1, 0, 0)))

    GEB2 = bld.translate(GEB2, 0, float(GEB2.bounds().size()[1]) * 1.5, 0)

    shape = bld.union(GEB1, GEB2)
    return bld.scale(shape, 0.3)


def plantpot_profile(bld: Builder):
    """The plant pot base's polygon profile, which the example revolves
    about the axis and renders to a 1080 x 1080 PNG (reference
    examples/plantpot/main.go:33-64)."""
    pot_base_radius = 40.0
    base_height = 10.0
    base_inclination = 45.0 * math.pi / 180
    base_wall_thick = 5.0
    base_lip_radius = base_wall_thick * 0.54

    x_off = base_height * math.sin(base_inclination)
    poly = PolygonBuilder()
    poly.add_xy(0, 0)
    poly.add_xy(pot_base_radius, 0)
    poly.add_xy(pot_base_radius + x_off, base_height)
    poly.add_relative_xy(base_wall_thick / 3, -base_wall_thick).arc(-base_lip_radius, 20)
    poly.add_xy(pot_base_radius + base_wall_thick / 2, -base_wall_thick)
    poly.add_xy(0, -base_wall_thick)
    return bld.new_polygon(poly.vertices())


def mandala_scene2d(bld: Builder):
    """The mandala: a 12-way circular array of an annular circle-hexagon
    union, which the example renders to a 768 x 768 PNG (reference
    examples/ui-mandala/mandala.go:12-21)."""
    circle = bld.translate2d(bld.new_circle(1), 1, 1)
    shape = bld.union2d(circle, bld.new_hexagon(1))
    shape = bld.offset2d(shape, 0.2)
    shape = bld.annulus(shape, 0.3)
    shape = bld.translate2d(shape, 3, 0)
    return bld.circular_array2d(shape, 12, 12)


def showerhead_thread_profile(bld: Builder):
    """The 2D profile of the showerhead's plastic buttress thread, which
    `showerhead_scene(bld, thread_png=...)` renders at 512 x 512."""
    return threads.PlasticButtress(d=65.0, p=5.0 / 3.0).thread(bld)


#: (scene name, builder function, PNG width, height) as the examples render them
PNG_SCENES = (
    ("plantpot", plantpot_profile, 1080, 1080),
    ("mandala", mandala_scene2d, 768, 768),
    ("showerhead-thread", showerhead_thread_profile, 512, 512),
)


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


def build_bolt():
    bld = Builder()
    return _checked(bld, bolt_scene(bld))


def build_knurled():
    bld = Builder()
    return _checked(bld, knurled_scene(bld))


def build_geb():
    bld = Builder()
    return _checked(bld, geb_scene(bld))
