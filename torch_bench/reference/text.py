"""Plain PyTorch text nodes and the plain nodes a text sculpture needs
beside `sdf.py`'s: glyph outlines from a TrueType font as winding-number
polygons, extrusion, offsets, 4x4 transforms and rotations. It imports
nothing of the program under test and no font package: it reads the
TrueType file itself (`TrueTypeFile`).

The expressions are those of the published CAD kernel (soypat/gsdf:
forge/textsdf/font.go, cpu_evaluators.go, operations.go, operations2d.go),
in float32. Departures from it:

- the font is read as TrueType (quadratic glyf outlines of simple glyphs,
  a format 4 Unicode cmap), where upstream reads any sfnt; a glyph's
  segments are flattened by adaptive bisection, at most 4 levels deep: a segment is split in two while one of
  its control points lies farther than the tolerance from its chord. The
  tolerance is the relative tolerance times the font's smaller global box
  side (font.go:286-291,311 sample with the spline sampler's bisection);
- a contour's points are rounded to float32 and then scaled by the
  float32 1 / (smaller global box side), so that side is 1 (font.go:
  208-212); outlines are y-up, so the y negation (font.go:332) is not
  needed;
- fills and holes are told apart by winding (clockwise, a negative signed
  area, fills): the fills joined, each hole subtracted in contour order.
  Upstream takes the first contour as the fill (font.go:237-255), which
  DejaVu's contour order breaks;
- a rotation's matrix is computed in float64 and rounded once to float32;
  a transform's inverse is the float64 inverse of its float32 matrix,
  rounded to float32, as upstream inverts it.

`distance` keeps the dtype of `p` (the control evaluates bfloat16 points).
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import sdf

_f32 = np.float32
#: bisection levels of a glyph segment
DEPTH = 4


# --- glyph outlines ---------------------------------------------------------
def _off_chord(c, a, b) -> float:
    """The distance of c from the line through a and b (from a where a = b)."""
    dx, dy = b[0] - a[0], b[1] - a[1]
    l2 = dx * dx + dy * dy
    if l2 == 0:
        return float(np.hypot(c[0] - a[0], c[1] - a[1]))
    return abs(dy * (c[0] - a[0]) - dx * (c[1] - a[1])) / (l2 ** 0.5)


def _mid(a, b):
    return ((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)


def _bisect(out, pts, tol, depth):
    """Append the inner points of the Bézier segment `pts` (start, control
    points, end), bisected while a control point is off its chord by more
    than `tol`."""
    a, b = pts[0], pts[-1]
    if depth <= 0 or all(_off_chord(c, a, b) <= tol for c in pts[1:-1]):
        return
    left, right, row = [pts[0]], [pts[-1]], list(pts)
    while len(row) > 1:  # de Casteljau at t = 1/2
        row = [_mid(row[i], row[i + 1]) for i in range(len(row) - 1)]
        left.append(row[0])
        right.insert(0, row[-1])
    _bisect(out, left, tol, depth - 1)
    out.append(left[-1])
    _bisect(out, right, tol, depth - 1)


def _outline(points, tol) -> list:
    """The closed polyline of one TrueType contour of (x, y, on-curve)
    points, from its first on-curve point (from the midpoint of its last and
    first points where it has none) back to it: a quadratic between two
    on-curve points, an on-curve point implied between two off-curve ones,
    each flattened to `tol`."""
    if any(on for _, _, on in points):
        k = next(i for i, (_, _, on) in enumerate(points) if on)
        seq = points[k:] + points[:k]
    else:
        seq = [(*_mid(points[-1], points[0]), True)] + list(points)
    seq = seq + seq[:1]
    out, a, offs = [seq[0][:2]], seq[0][:2], []
    for x, y, on in seq[1:]:
        if not on:
            offs.append((x, y))
            continue
        for j, c in enumerate(offs):
            b = (x, y) if j == len(offs) - 1 else _mid(c, offs[j + 1])
            _bisect(out, [a, c, b], tol, DEPTH)
            out.append(b)
            a = b
        if not offs:
            out.append((x, y))
        a, offs = (x, y), []
    return out


class TrueTypeFile:
    """The tables of a TrueType font file that glyph outlines need: head,
    maxp, hhea, hmtx, loca, glyf and a format 4 Unicode cmap."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.b = f.read()
        self.tab = {self.b[12 + 16 * i:16 + 16 * i].decode("latin-1"):
                    self._u("I", 20 + 16 * i) for i in range(self._u("H", 4))}
        head = self.tab["head"]
        self.box = [self._u("h", head + 36 + 2 * k) for k in range(4)]
        self.n = self._u("H", self.tab["maxp"] + 4)
        self.long_loca = self._u("h", head + 50) == 1
        self.n_metrics = self._u("H", self.tab["hhea"] + 34)

    def _u(self, fmt, at):
        return struct.unpack_from(">" + fmt, self.b, at)[0]

    def glyph_id(self, code: int) -> int:
        """The glyph of `code` in the Unicode cmap (3, 1) or (0, 3)."""
        cmap = self.tab["cmap"]
        subs = {(self._u("H", cmap + 4 + 8 * i), self._u("H", cmap + 6 + 8 * i)):
                cmap + self._u("I", cmap + 8 + 8 * i) for i in range(self._u("H", cmap + 2))}
        t = subs.get((3, 1), subs.get((0, 3)))
        if t is None or self._u("H", t) != 4:
            raise ValueError("the reference reads a format 4 Unicode cmap only")
        segs = self._u("H", t + 6) // 2
        for i in range(segs):
            end, first = self._u("H", t + 14 + 2 * i), self._u("H", t + 16 + 2 * segs + 2 * i)
            if first <= code <= end:
                delta = self._u("h", t + 16 + 4 * segs + 2 * i)
                at = t + 16 + 6 * segs + 2 * i
                ro = self._u("H", at)
                g = code if ro == 0 else self._u("H", at + ro + 2 * (code - first))
                return (g + delta) & 0xFFFF if g else 0
        return 0

    def points(self, gid: int) -> list:
        """The glyph's contours as lists of (x, y, on-curve), moved by its
        left side bearing less its xMin."""
        at = (self._u("I", self.tab["loca"] + 4 * gid) if self.long_loca
              else 2 * self._u("H", self.tab["loca"] + 2 * gid))
        g = self.tab["glyf"] + at
        n = self._u("h", g)
        ends = [self._u("H", g + 10 + 2 * i) for i in range(n)]
        at = g + 10 + 2 * n
        at += 2 + self._u("H", at)
        flags = []
        while len(flags) <= ends[-1]:
            f = self.b[at]
            reps = 1 + (self.b[at + 1] if f & 8 else 0)
            at += 2 if f & 8 else 1
            flags += [f] * reps
        xy = []
        for short, same in ((2, 16), (4, 32)):
            v, vs = 0, []
            for f in flags[:ends[-1] + 1]:
                if f & short:
                    v += self.b[at] if f & same else -self.b[at]
                    at += 1
                elif not f & same:
                    v += self._u("h", at)
                    at += 2
                vs.append(v)
            xy.append(vs)
        lsb_at = (self.tab["hmtx"] + 4 * gid + 2 if gid < self.n_metrics
                  else self.tab["hmtx"] + 4 * self.n_metrics + 2 * (gid - self.n_metrics))
        dx = self._u("h", lsb_at) - self._u("h", g + 2)
        pts = [(x + dx, y, bool(f & 1)) for x, y, f in zip(*xy, flags)]
        return [pts[s:e + 1] for s, e in zip([0] + [e + 1 for e in ends[:-1]], ends)]


def glyph_polygons(font_path: str, char: str, reltol: float) -> list:
    """The float32 (V, 2) contours of `char`'s glyph in the font at
    `font_path`, flattened to `reltol` of the font's smaller global box side
    and scaled so that side is 1."""
    font = TrueTypeFile(font_path)
    x0, y0, x1, y1 = font.box
    scale = 1.0 / min(x1 - x0, y1 - y0)
    out = []
    for contour in font.points(font.glyph_id(ord(char))):
        a = np.array(_outline(contour, reltol / max(scale, 1e-12)), _f32) * _f32(scale)
        if len(a) > 1 and np.array_equal(a[0], a[-1]):
            a = a[:-1]  # the closing point
        a = a[np.r_[True, np.any(a[1:] != a[:-1], axis=1)]]
        if len(a) >= 3:
            out.append(a)
    return out


def _signed_area(a) -> float:
    x, y = a[:, 0].astype(np.float64), a[:, 1].astype(np.float64)
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def glyph(font_path: str, char: str, reltol: float):
    """The 2D node of a glyph: its fills joined, less each hole."""
    contours = glyph_polygons(font_path, char, reltol)
    fills = [sdf.Polygon(c) for c in contours if _signed_area(c) < 0]
    holes = [sdf.Polygon(c) for c in contours if _signed_area(c) >= 0]
    shape = fills[0] if len(fills) == 1 else sdf.Union(fills)
    for h in holes:
        shape = sdf.Difference(shape, h)
    return shape


# --- nodes ------------------------------------------------------------------
class Offset:
    """The child's distance plus `off` (2D and 3D); a 2D box grows by -off
    where off <= 0 and stays where off > 0 (operations2d.go:421-430), a 3D
    box by -off, put in order (operations.go:446)."""

    def __init__(self, s, off):
        self.s, self.off = s, _f32(off)

    def distance(self, p):
        return self.s.distance(p) + sdf.lit(self.off)

    def bounds(self):
        lo, hi = self.s.bounds()
        if len(lo) == 2:
            return (lo, hi) if self.off > 0 else sdf._box(lo + self.off, hi - self.off)
        lo, hi = lo + self.off, hi - self.off
        return sdf._box(np.minimum(lo, hi), np.maximum(lo, hi))


class Extrude:
    """A 2D shape extruded along z to height h, centred
    (cpu_evaluators.go:506)."""

    def __init__(self, s, h):
        self.s, self.h = s, _f32(h)

    def distance(self, p):
        d = self.s.distance(p[..., :2])
        w = torch.abs(p[..., 2]) - sdf.lit(self.h / _f32(2))
        return torch.clamp(torch.maximum(d, w), max=0.0) + sdf.hypot(
            torch.clamp(d, min=0.0), torch.clamp(w, min=0.0))

    def bounds(self):
        lo, hi = self.s.bounds()
        hh = self.h / 2
        return sdf._box([lo[0], lo[1], -hh], [hi[0], hi[1], hh])


class Transform:
    """The child at the point mapped by the inverse of a 4x4 matrix
    (cpu_evaluators.go:488): each coordinate ((x r0 + y r1) + z r2) + t."""

    def __init__(self, s, mat4):
        self.s = s
        self.m = np.asarray(mat4, _f32).reshape(4, 4)
        self.inv = np.linalg.inv(self.m.astype(np.float64)).astype(_f32)

    def distance(self, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        r = [[sdf.lit(v) for v in row] for row in self.inv[:3]]
        return self.s.distance(torch.stack(
            [x * r[i][0] + y * r[i][1] + z * r[i][2] + r[i][3] for i in range(3)], dim=-1))

    def bounds(self):
        """The box of the child's 8 corners mapped by the matrix."""
        lo, hi = self.s.bounds()
        corners = np.array([[(hi if i >> d & 1 else lo)[d] for d in range(3)] + [1]
                            for i in range(8)], _f32)
        out = (self.m @ corners.T).T[:, :3]
        return sdf._box(out.min(axis=0), out.max(axis=0))


def rotation(radians: float, axis) -> np.ndarray:
    """The 4x4 right-handed rotation by `radians` about `axis` (Rodrigues'
    formula in float64, rounded once to float32)."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(np.asarray(axis, np.float64))
    s, c = math.sin(radians), math.cos(radians)
    k = 1.0 - c
    return np.array([[k * x * x + c, k * x * y - z * s, k * z * x + y * s, 0],
                     [k * x * y + z * s, k * y * y + c, k * y * z - x * s, 0],
                     [k * z * x - y * s, k * y * z + x * s, k * z * z + c, 0],
                     [0, 0, 0, 1]], np.float64).astype(_f32)


def Rotate(s, radians: float, axis) -> Transform:
    return Transform(s, rotation(radians, axis))


def scaling(sx, sy, sz) -> np.ndarray:
    """The 4x4 float32 matrix of a scale by (sx, sy, sz)."""
    m = np.eye(4, dtype=_f32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m
