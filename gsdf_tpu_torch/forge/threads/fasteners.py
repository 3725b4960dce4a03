"""Fasteners of the ported slice (gsdf_tpu/forge/threads/fasteners.py):
knurls and the circular nut."""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from ...core.node import Shader2D, Shader3D
from ...geometry.polygon import PolygonBuilder
from .core import Parameters, Threader, screw
from .standards import ISO

_f32 = np.float32


class NutStyle(enum.Enum):
    """(reference nut.go:12-37)."""

    CIRCULAR = "circular"
    HEX = "hex"
    KNURL = "knurl"


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
class NutParams:
    """(reference nut.go:40-46)."""

    thread: Threader
    style: NutStyle = NutStyle.HEX
    tolerance: float = 0.0  # add to internal thread radius


def nut(bld, k: NutParams) -> Shader3D:
    """Simple nut suitable for 3D printing (reference nut.go:49-80). The
    port builds the CIRCULAR style; hex and knurl bodies need node types
    outside the slice."""
    if k.thread is None:
        raise ValueError("nil threader")
    if k.tolerance < 0:
        raise ValueError("tolerance < 0")
    params = k.thread.thread_params()
    nr = params.hex_radius()
    nh = params.hex_height()
    if nr <= 0 or nh <= 0:
        raise ValueError("bad hex nut dimensions")
    if k.style != NutStyle.CIRCULAR:
        raise NotImplementedError(f"nut style {k.style} is not ported yet")
    # float32 steps match the reference's Go arithmetic (nut.go:70,77)
    body = bld.new_cylinder(float(_f32(nr) * _f32(1.1)), nh, 0)
    thread = screw(bld, float(_f32(nh) * _f32(1 + 1e-2)), k.thread)
    return bld.difference(body, thread)
