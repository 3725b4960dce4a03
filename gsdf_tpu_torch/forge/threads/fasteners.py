"""Fasteners (gsdf_tpu/forge/threads/fasteners.py): hex heads, knurls,
bolts and nuts (reference forge/threads/{bolt,nut,hexhead,knurl}.go)."""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from ...core.node import Shader2D, Shader3D
from ...geometry.polygon import PolygonBuilder
from .core import COSD30, Parameters, Threader, screw
from .standards import ISO

_f32 = np.float32


class NutStyle(enum.Enum):
    """(reference nut.go:12-37)."""

    CIRCULAR = "circular"
    HEX = "hex"
    KNURL = "knurl"


def hex_head(bld, radius: float, height: float, round_neg: bool, round_pos: bool) -> Shader3D:
    """Rounded hex head (reference hexhead.go:15-48)."""
    corner_round = radius * 0.08
    poly = PolygonBuilder()
    poly.nagon(6, radius - corner_round)
    hex2d = bld.new_polygon(poly.vertices())
    hex2d = bld.offset2d(hex2d, -corner_round)
    hex3d = bld.extrude(hex2d, height)
    if round_pos or round_neg:
        top_round = radius * 1.6
        d = radius * COSD30
        sphere = bld.new_sphere(top_round)
        z_ofs = math.sqrt(top_round * top_round - d * d) - height / 2
        if round_neg:
            hex3d = bld.intersection(hex3d, bld.translate(sphere, 0, 0, -z_ofs))
        if round_pos:
            hex3d = bld.intersection(hex3d, bld.translate(sphere, 0, 0, z_ofs))
    return hex3d


@dataclasses.dataclass
class KnurlParams(Threader):
    """Knurl parameters; also a Threader for the spiral construction
    (reference knurl.go:17-48)."""

    length: float  # length of cylinder
    radius: float  # radius of cylinder
    pitch: float  # knurl pitch
    height: float  # knurl height
    theta: float  # knurl helix angle
    starts: int = 0

    def thread(self, bld) -> Shader2D:
        poly = PolygonBuilder()
        poly.add_xy(self.pitch / 2, 0)
        poly.add_xy(self.pitch / 2, self.radius)
        poly.add_xy(0, self.radius + self.height)
        poly.add_xy(-self.pitch / 2, self.radius)
        poly.add_xy(-self.pitch / 2, 0)
        return bld.new_polygon(poly.vertices())

    def thread_params(self) -> Parameters:
        p = ISO(d=self.radius * 2, p=self.pitch, ext=True).thread_params()
        p.starts = self.starts
        return p


def knurl(bld, k: KnurlParams) -> Shader3D:
    """Knurled cylinder as intersection of left/right multistart screws
    (reference knurl.go:52-82)."""
    if k.length <= 0:
        raise ValueError("zero or negative knurl length")
    if k.radius <= 0:
        raise ValueError("zero or negative knurl radius")
    if k.pitch <= 0:
        raise ValueError("zero or negative knurl pitch")
    if k.height <= 0:
        raise ValueError("zero or negative knurl height")
    if k.theta < 0:
        raise ValueError("zero knurl helix angle")
    if k.theta >= math.pi / 2:
        raise ValueError("too large knurl helix angle")
    # helix-angle start count in the reference's float32 chain
    # (knurl.go:68); KnurlParams is not mutated (Go passes it by value)
    tan32 = _f32(math.tan(float(_f32(k.theta))))
    starts = int(
        _f32(_f32(_f32(_f32(2 * math.pi) * _f32(k.radius)) * tan32) / _f32(k.pitch))
    )
    knurl0 = screw(bld, k.length, dataclasses.replace(k, starts=starts))
    knurl1 = screw(bld, k.length, dataclasses.replace(k, starts=-starts))
    return bld.intersection(knurl0, knurl1)


def knurled_head(bld, radius: float, height: float, pitch: float) -> Shader3D:
    """Generic cylindrical knurled head (reference knurl.go:85-101)."""
    cylinder_round = radius * 0.05
    knurl_length = pitch * math.floor((height - cylinder_round) / pitch)
    k = KnurlParams(
        length=knurl_length,
        radius=radius,
        pitch=pitch,
        height=pitch * 0.3,
        theta=45.0 * math.pi / 180,
    )
    kn = knurl(bld, k)
    cylinder = bld.new_cylinder(radius, height, cylinder_round)
    return bld.union(cylinder, kn)


@dataclasses.dataclass
class BoltParams:
    """(reference bolt.go:12-19)."""

    thread: Threader
    style: NutStyle = NutStyle.HEX
    tolerance: float = 0.0  # subtract from external thread radius
    total_length: float = 0.0  # threaded length + shank length
    shank_length: float = 0.0  # non-threaded length


def bolt(bld, k: BoltParams) -> Shader3D:
    """Simple bolt suitable for 3D printing (reference bolt.go:22-80)."""
    if k.thread is None:
        raise ValueError("nil threader")
    if k.total_length < 0:
        raise ValueError("total length < 0")
    if k.shank_length >= k.total_length:
        raise ValueError("shank length must be less than total length")
    if k.shank_length <= 0:
        raise ValueError("shank length <= 0")
    if k.tolerance < 0:
        raise ValueError("tolerance < 0")
    param = k.thread.thread_params()

    hr = param.hex_radius()
    hh = param.hex_height()
    if hr <= 0 or hh <= 0:
        raise ValueError("bad hex head dimension")
    if k.style == NutStyle.HEX:
        head = hex_head(bld, hr, hh, False, True)  # round top side only
    elif k.style == NutStyle.KNURL:
        head = knurled_head(bld, hr, hh, hr * 0.25)
    else:
        raise ValueError(f"unknown style for bolt: {k.style}")

    screw_len = k.total_length - k.shank_length
    scr = screw(bld, screw_len, k.thread)
    shank = bld.new_cylinder(param.radius, k.shank_length, hh * 0.08)
    shank_off = k.shank_length / 2 + hh / 2
    shank = bld.translate(shank, 0, 0, shank_off)
    scr = bld.translate(scr, 0, 0, shank_off + screw_len / 2)
    return bld.union(scr, bld.smooth_union(hh * 0.12, shank, head))


@dataclasses.dataclass
class NutParams:
    """(reference nut.go:40-46)."""

    thread: Threader
    style: NutStyle = NutStyle.HEX
    tolerance: float = 0.0  # add to internal thread radius


def nut(bld, k: NutParams) -> Shader3D:
    """Simple nut suitable for 3D printing (reference nut.go:49-80)."""
    if k.thread is None:
        raise ValueError("nil threader")
    if k.tolerance < 0:
        raise ValueError("tolerance < 0")
    params = k.thread.thread_params()
    nr = params.hex_radius()
    nh = params.hex_height()
    if nr <= 0 or nh <= 0:
        raise ValueError("bad hex nut dimensions")
    if k.style == NutStyle.HEX:
        body = hex_head(bld, nr, nh, True, True)
    elif k.style == NutStyle.KNURL:
        body = knurled_head(bld, nr, nh, nr * 0.25)
    elif k.style == NutStyle.CIRCULAR:
        # float32 steps match the reference's Go arithmetic (nut.go:70,77)
        body = bld.new_cylinder(float(_f32(nr) * _f32(1.1)), nh, 0)
    else:
        raise ValueError("unknown NutStyle for nut")
    thread = screw(bld, float(_f32(nh) * _f32(1 + 1e-2)), k.thread)
    return bld.difference(body, thread)


def chamfered_cylinder(bld, s: Shader3D, kb: float, kt: float) -> Shader3D:
    """Intersect s with a chamfered cylinder (reference bolt.go:82-95)."""
    bb = s.bounds()
    l = float(bb.max[2])
    r = float(bb.max[0])
    poly = PolygonBuilder()
    poly.add_xy(0, -l)
    poly.add_xy(r, -l).chamfer(r * kb)
    poly.add_xy(r, l).chamfer(r * kt)
    poly.add_xy(0, l)
    s2 = bld.new_polygon(poly.vertices())
    cc = bld.revolve(s2, 0)
    return bld.intersection(s, cc)
