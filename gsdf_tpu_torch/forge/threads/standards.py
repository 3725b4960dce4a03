"""Thread standards (gsdf_tpu/forge/threads/standards.py): ISO, NPT, UTS,
Acme, ANSI buttress and plastic buttress. Each profile is a host-built
polygon of one pitch period swept by the screw node."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ...geometry.polygon import PolygonBuilder
from .core import COSD30, SIND30, Basic, Parameters, Threader


@dataclasses.dataclass
class ISO(Threader):
    """ISO metric thread (reference iso.go:21-77). For M16x2, d=16, p=2."""

    d: float  # nominal diameter
    p: float  # pitch
    #: external (screws) vs internal (tapped holes); False is Go's zero
    #: value, which NPT relies on (npt.go:37)
    ext: bool = False

    def thread_params(self) -> Parameters:
        return Basic(self.d, self.p).thread_params()

    def thread(self, bld):
        radius = self.d / 2
        tan_theta = SIND30 / COSD30
        h = self.p / (2.0 * tan_theta)
        r_major = radius
        r0 = r_major - (7.0 / 8.0) * h
        poly = PolygonBuilder()
        if self.ext:
            r_root = (self.p / 8.0) / COSD30
            x_ofs = (1.0 / 16.0) * self.p
            poly.add_xy(self.p, 0)
            poly.add_xy(self.p, r0 + h)
            poly.add_xy(self.p / 2.0, r0).smooth(r_root, 5)
            poly.add_xy(x_ofs, r_major)
            poly.add_xy(-x_ofs, r_major)
            poly.add_xy(-self.p / 2.0, r0).smooth(r_root, 5)
            poly.add_xy(-self.p, r0 + h)
            poly.add_xy(-self.p, 0)
        else:
            r_minor = r0 + (1.0 / 4.0) * h
            r_crest = (self.p / 16.0) / COSD30
            x_ofs = (1.0 / 8.0) * self.p
            poly.add_xy(self.p, 0)
            poly.add_xy(self.p, r_minor)
            poly.add_xy(self.p / 2 - x_ofs, r_minor)
            poly.add_xy(0, r0 + h).smooth(r_crest, 5)
            poly.add_xy(-self.p / 2 + x_ofs, r_minor)
            poly.add_xy(-self.p, r_minor)
            poly.add_xy(-self.p, 0)
        return bld.new_polygon(poly.vertices())


@dataclasses.dataclass
class NPT(Threader):
    """National pipe taper thread (reference npt.go:12-74)."""

    d: float = 0.0  # nominal diameter
    tpi: float = 0.0  # threads per inch
    f2f: float = 0.0  # hex flat-to-flat (settable from nominal table)

    def _pitch(self) -> float:
        # f32 division like the reference's `1.0 / npt.TPI` (npt.go:27)
        return float(np.float32(1.0) / np.float32(self.tpi))

    def thread_params(self) -> Parameters:
        p = ISO(d=self.d, p=self._pitch()).thread_params()
        p.name = "NPT"
        # standard NPT taper; single-precision atan like math32.Atan (npt.go:27)
        p.taper = float(np.arctan(np.float32(1.0 / 32.0), dtype=np.float32))
        if self.f2f > 0:
            p.hex_f2f = self.f2f
        return p

    def thread(self, bld):
        # the reference leaves ISO.Ext at Go's zero value (false), so NPT
        # threads cut with the INTERNAL profile (npt.go:37)
        return ISO(d=self.d, p=self._pitch(), ext=False).thread(bld)

    # nominal, major diameter, TPI, hex flat-to-flat (npt.go:40-55)
    _LOOKUP = [
        (1 / 8, 0.405, 27, 11.2 / 25.4),
        (1 / 4, 0.540, 18, 15.7 / 25.4),
        (3 / 8, 0.675, 18, 17.5 / 25.4),
        (1 / 2, 0.840, 14, 22.4 / 25.4),
        (3 / 4, 1.050, 14, 26.9 / 25.4),
        (1.0, 1.315, 11.5, 35.1 / 25.4),
        (1 + 1 / 4, 1.660, 11.5, 44.5 / 25.4),
        (1 + 1 / 2, 1.900, 11.5, 50.8 / 25.4),
        (2.0, 2.375, 11.5, 63.5 / 25.4),
        (2 + 1 / 2, 2.875, 8, 76.2 / 25.4),
        (3.0, 3.500, 8, 88.9 / 25.4),
        (4.0, 4.500, 8, 117.3 / 25.4),
    ]

    def set_from_nominal(self, nominal: float) -> None:
        """Set dimensions from a nominal inch-fraction measurement
        (reference npt.go:62-74)."""
        tol = 1.0 / 32.0
        for n, d, tpi, ftof in self._LOOKUP:
            if abs(n - nominal) < tol:
                self.d = d
                self.f2f = ftof
                self.tpi = tpi
                return
        raise ValueError("nominal measurement not found")


@dataclasses.dataclass
class UTS(Threader):
    """Unified thread standard (reference uts.go:12-31)."""

    d: float
    tpi: float
    ext: bool = False  # Go zero-value default, as in the reference

    def thread_params(self) -> Parameters:
        return Basic(self.d, 1.0 / self.tpi).thread_params()

    def thread(self, bld):
        return ISO(d=self.d, p=1.0 / self.tpi, ext=self.ext).thread(bld)


@dataclasses.dataclass
class Acme(Threader):
    """Trapezoidal thread form (reference acme.go:11-48)."""

    d: float
    p: float

    def thread_params(self) -> Parameters:
        return Basic(self.d, self.p).thread_params()

    def thread(self, bld):
        radius = self.d / 2
        h = radius - 0.5 * self.p
        theta = (29.0 / 2.0) * math.pi / 180.0
        delta = 0.25 * self.p * math.tan(theta)
        x_ofs0 = 0.25 * self.p - delta
        x_ofs1 = 0.25 * self.p + delta
        poly = PolygonBuilder()
        poly.add_xy(radius, 0)
        poly.add_xy(radius, h)
        poly.add_xy(x_ofs1, h)
        poly.add_xy(x_ofs0, radius)
        poly.add_xy(-x_ofs0, radius)
        poly.add_xy(-x_ofs1, h)
        poly.add_xy(-radius, h)
        poly.add_xy(-radius, 0)
        return bld.new_polygon(poly.vertices())


@dataclasses.dataclass
class ANSIButtress(Threader):
    """ANSI 45/7 buttress thread, ASME B1.9-1973
    (reference ansibuttress.go:10-51)."""

    d: float
    p: float

    def thread_params(self) -> Parameters:
        return Basic(self.d, self.p).thread_params()

    def thread(self, bld):
        radius = self.d / 2
        t0 = math.tan(45.0 * math.pi / 180)
        t1 = math.tan(7.0 * math.pi / 180)
        thread_eng = 0.6
        h0 = self.p / (t0 + t1)
        h1 = ((thread_eng / 2.0) * self.p) + (0.5 * h0)
        hp = self.p / 2.0
        tp = PolygonBuilder()
        tp.add_xy(self.p, 0)
        tp.add_xy(self.p, radius)
        tp.add_xy(hp - ((h0 - h1) * t1), radius)
        tp.add_xy(t0 * h0 - hp, radius - h1).smooth(0.0714 * self.p, 5)
        tp.add_xy((h0 - h1) * t0 - hp, radius)
        tp.add_xy(-self.p, radius)
        tp.add_xy(-self.p, 0)
        return bld.new_polygon(tp.vertices())


@dataclasses.dataclass
class PlasticButtress(Threader):
    """Screw-top style plastic buttress thread with extra corner rounding
    (reference plasticbuttress.go:9-53)."""

    d: float
    p: float

    def thread_params(self) -> Parameters:
        return Basic(self.d, self.p).thread_params()

    def thread(self, bld):
        radius = self.d / 2
        t0 = 1.0  # tan(45 deg)
        t1 = 0.1227845609029046  # tan(7 deg)
        thread_engage = 0.6
        p = self.p
        h0 = p / (t0 + t1)
        h1 = ((thread_engage / 2.0) * p) + (0.5 * h0)
        hp = p / 2.0
        tp = PolygonBuilder()
        tp.add_xy(p, 0)
        tp.add_xy(p, radius)
        tp.add_xy(hp - ((h0 - h1) * t1), radius).smooth(0.05 * p, 5)
        tp.add_xy(t0 * h0 - hp, radius - h1).smooth(0.15 * p, 5)
        tp.add_xy((h0 - h1) * t0 - hp, radius).smooth(0.15 * p, 5)
        tp.add_xy(-p, radius)
        tp.add_xy(-p, 0)
        return bld.new_polygon(tp.vertices())
