"""Plain reference of the NPT flange, the published CAD kernel's README
benchmark part (soypat/gsdf examples/npt-flange/flange.go:23-58): a 1/2"
NPT threaded pipe (a circular nut cut by the tapered internal ISO thread
profile) smooth-joined to a rounded base plate, a through-hole, scaled from
inches to millimetres. Built from the published dimensions alone.

`part(values)` takes the continuous dimensions an edit may set, by name
(`ORIGINAL` holds the published ones).
"""
from __future__ import annotations

import math

import numpy as np

from torch_bench.reference import sdf

_f32 = np.float32

TLEN = 18.0 / 25.4
INTERNAL_DIAMETER = 1.5 / 2.0
FLANGE_H = 7.0 / 25.4
FLANGE_D = 60.0 / 25.4
# 1/2" NPT (npt.go:40-55): major diameter, threads per inch, hex flat-to-flat
NPT_D, NPT_TPI, NPT_F2F = 0.840, 14, 22.4 / 25.4
COSD30, SIND30 = math.sqrt(3) / 2, 0.5

ORIGINAL = {
    "hole_r": _f32(INTERNAL_DIAMETER / 2),
    "blend_k": _f32(0.2),
    "plate_dz": _f32(-TLEN / 2),
}


def iso_internal_profile(d: float, p: float) -> np.ndarray:
    """One pitch of the internal ISO thread profile (iso.go:50-76)."""
    radius = d / 2
    h = p / (2.0 * (SIND30 / COSD30))
    r0 = radius - (7.0 / 8.0) * h
    r_minor = r0 + h / 4.0
    r_crest = (p / 16.0) / COSD30
    x_ofs = p / 8.0
    return sdf.polygon_vertices([
        (p, 0), (p, r_minor), (p / 2 - x_ofs, r_minor), (0, r0 + h, r_crest, 5),
        (-p / 2 + x_ofs, r_minor), (-p, r_minor), (-p, 0),
    ])


def part(values=None):
    v = {**ORIGINAL, **(values or {})}
    pitch = float(_f32(1.0) / _f32(NPT_TPI))
    taper = float(np.arctan(_f32(1.0 / 32.0), dtype=_f32))
    # a circular nut (nut.go:49-80): body radius 1.1 x the hex radius
    hex_r = float(_f32(NPT_F2F) / (_f32(2.0) * _f32(COSD30)))
    hex_h = float(_f32(2.0) * _f32(hex_r) * (_f32(5.0) / _f32(12.0)))
    body = sdf.Cylinder(float(_f32(hex_r) * _f32(1.1)), hex_h, 0)
    length = float(_f32(hex_h) * _f32(1 + 1e-2))
    thread = sdf.Screw(sdf.Polygon(iso_internal_profile(NPT_D, pitch)), pitch, -pitch,
                       length / 2, taper)
    pipe = sdf.Difference(body, thread)
    plate = sdf.Translate(sdf.Cylinder(FLANGE_D / 2, FLANGE_H, FLANGE_H / 8),
                          [0, 0, v["plate_dz"]])
    joined = sdf.SmoothUnion(v["blend_k"], pipe, plate)
    hole = sdf.Cylinder(v["hole_r"], 4 * FLANGE_H, 0)
    return sdf.Scale(sdf.Difference(joined, hole), 25.4)
