"""Plain PyTorch signed-distance nodes: the benchmark's own reference for
the parts it renders. It imports nothing of the program under test.

Each node is a small object with `distance(p)` over (..., 3) or (..., 2)
points and `bounds()`, a (min, max) pair of float32 numpy arrays. The
expressions are those of the published CAD kernel (soypat/gsdf,
cpu_evaluators.go), in float32:

- a division by a constant goes through a 0-dim tensor, so it is the IEEE
  quotient on every device (a CUDA division by a Python scalar multiplies
  by the reciprocal);
- on the CPU, sqrt runs in float64 and is rounded once (torch's float32
  CPU sqrt is not correctly rounded); on the card it is the CUDA math
  library's precise sqrtf.

`distance` keeps the dtype of `p`: the control of `correct` evaluates the
same nodes on bfloat16 points.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_f32 = np.float32
LARGENUM = 1e20


def lit(x) -> float:
    """A constant as the Python float of its float32 value."""
    return float(_f32(x))


def const(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(np.asarray(x, _f32), device=like.device).to(like.dtype)


def div(a, b) -> torch.Tensor:
    if not isinstance(b, torch.Tensor):
        b = const(b, a)
    return a / b


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def hypot(x, y):
    return sqrt(x * x + y * y)


#: elements of a (points, copies) temporary before `rows` splits the points
ROW_ELEMENTS = 1 << 25


def rows(fn, p, copies: int):
    """fn over the points of p (..., D), in slices of at most ROW_ELEMENTS /
    copies points, for a fn that makes a (points, copies) temporary."""
    flat = p.reshape(-1, p.shape[-1])
    step = max(1, ROW_ELEMENTS // max(1, copies))
    if len(flat) <= step:
        return fn(p)
    out = torch.cat([fn(flat[i:i + step]) for i in range(0, len(flat), step)])
    return out.reshape(p.shape[:-1])


def _box(lo, hi):
    return np.asarray(lo, _f32), np.asarray(hi, _f32)


def box_union(a, b):
    return _box(np.minimum(a[0], b[0]), np.maximum(a[1], b[1]))


class Cylinder:
    """Cylinder about z, height h, edge rounding `round`."""

    def __init__(self, r, h, round=0.0):
        self.r, self.h, self.round = _f32(r), _f32(h), _f32(round)

    def distance(self, p):
        r = lit(self.r)
        rnd = lit(self.round)
        hh = lit((self.h - _f32(2) * self.round) / _f32(2))
        d_axis = hypot(p[..., 0], p[..., 1])
        dy = torch.abs(p[..., 2]) - hh
        dx = d_axis - r if rnd == 0 else d_axis - r + rnd
        d = torch.clamp(torch.maximum(dx, dy), max=0.0) + hypot(
            torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0))
        return d if rnd == 0 else d - rnd

    def bounds(self):
        r, h = self.r, self.h
        return _box([-r, -r, -h / 2], [r, r, h / 2])


class Translate:
    def __init__(self, s, v):
        self.s, self.v = s, np.asarray(v, _f32)

    def distance(self, p):
        return self.s.distance(p - const(self.v, p))

    def bounds(self):
        lo, hi = self.s.bounds()
        return _box(lo + self.v, hi + self.v)


class Scale:
    """Uniform scale about the origin: the child at p / f, times f (the
    division as a multiply by the float32 reciprocal)."""

    def __init__(self, s, factor):
        self.s, self.factor = s, _f32(factor)

    def distance(self, p):
        inv = lit(_f32(1.0) / self.factor)
        return self.s.distance(p * inv) * lit(self.factor)

    def bounds(self):
        lo, hi = self.s.bounds()
        lo, hi = lo * self.factor, hi * self.factor
        return _box(np.minimum(lo, hi), np.maximum(lo, hi))


class Difference:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def distance(self, p):
        return torch.maximum(self.a.distance(p), -self.b.distance(p))

    def bounds(self):
        return self.a.bounds()


class Intersection:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def distance(self, p):
        return torch.maximum(self.a.distance(p), self.b.distance(p))

    def bounds(self):
        (alo, ahi), (blo, bhi) = self.a.bounds(), self.b.bounds()
        return _box(np.maximum(alo, blo), np.minimum(ahi, bhi))


class Union:
    """Exact n-ary union. `copies` of one child at many offsets are taken
    as (child, offsets) pairs: the minimum over its translates."""

    def __init__(self, children, copies=()):
        self.children = list(children)
        self.copies = [(c, np.asarray(o, _f32).reshape(-1, 3)) for c, o in copies]

    def distance(self, p):
        d = None
        for child, offsets in self.copies:
            off = const(offsets, p)  # (G, 3): every translate in one call
            dg = rows(lambda q: child.distance(q[..., None, :] - off).amin(dim=-1), p,
                      len(offsets))
            dg = torch.minimum(torch.full_like(dg, LARGENUM), dg)
            d = dg if d is None else torch.minimum(d, dg)
        for c in self.children:
            dc = c.distance(p)
            d = dc if d is None else torch.minimum(d, dc)
        return d

    def bounds(self):
        boxes = [c.bounds() for c in self.children]
        for child, offsets in self.copies:
            lo, hi = child.bounds()
            boxes += [_box(lo + o, hi + o) for o in offsets]
        out = boxes[0]
        for b in boxes[1:]:
            out = box_union(out, b)
        return out


class SmoothUnion:
    """Polynomial smooth minimum of radius k."""

    def __init__(self, k, a, b):
        self.k, self.a, self.b = _f32(k), a, b

    def distance(self, p):
        a, b = self.a.distance(p), self.b.distance(p)
        h = torch.clamp(0.5 + div(0.5 * (b - a), self.k), 0.0, 1.0)
        return (b * (1 - h) + a * h) - lit(self.k) * h * (1 - h)

    def bounds(self):
        return box_union(self.a.bounds(), self.b.bounds())


class Polygon:
    """Closed 2D polygon by the winding-number rule: the distance to the
    nearest edge, negative inside."""

    def __init__(self, vertices):
        self.vert = np.asarray(vertices, _f32).reshape(-1, 2)

    def distance(self, p):
        return rows(self._distance, p, len(self.vert))

    def _distance(self, p):
        """Every edge at once, on an (..., E) axis: v1 the edge's vertex, v2
        the one before it."""
        v1 = self.vert
        v2 = np.roll(self.vert, 1, axis=0)
        e = (v2 - v1).astype(_f32)
        ee = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]).astype(_f32)
        ex, ey, v1x, v1y, v2y = (const(a, p) for a in (e[:, 0], e[:, 1], v1[:, 0], v1[:, 1],
                                                       v2[:, 1]))
        px, py = p[..., 0, None], p[..., 1, None]
        wx, wy = px - v1x, py - v1y
        h = torch.clamp(div(wx * ex + wy * ey, const(ee, p)), 0.0, 1.0)
        bx, by = wx - h * ex, wy - h * ey
        d = (bx * bx + by * by).amin(dim=-1)
        d = torch.minimum(torch.full_like(d, float("inf")), d)
        b1, b2, b3 = py >= v1y, py < v2y, ex * wy > ey * wx
        flips = ((b1 & b2 & b3) | (~b1 & ~b2 & ~b3)).sum(dim=-1)
        sign = torch.where(flips % 2 == 1, -1.0, 1.0).to(p.dtype)
        return sign * sqrt(d)

    def bounds(self):
        return _box(self.vert.min(axis=0), self.vert.max(axis=0))


class Screw:
    """A 2D thread profile swept along a helix about z (threads.go:141-181):
    profile(sawtooth(z + lead * theta / 2pi), r + z tan(taper)), cut at
    |z| <= length / 2."""

    #: a domain warp, not 1-Lipschitz (raymarch.relaxation)
    WARPS = True

    def __init__(self, profile, pitch, lead, length_div2, taper=0.0):
        self.profile = profile
        self.pitch, self.lead = _f32(pitch), _f32(lead)
        self.length_div2, self.taper = _f32(length_div2), _f32(taper)

    def distance(self, p):
        tan_taper = np.tan(self.taper, dtype=_f32)
        two_pi = _f32(2 * math.pi)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        y = sqrt(px * px + py * py) + pz * lit(tan_taper)
        theta = torch.atan2(py, px)
        z = pz + div(lit(self.lead) * theta, two_pi)
        zz = z + lit(self.pitch / _f32(2))
        t = div(zz, self.pitch)
        x = lit(self.pitch) * (t - torch.floor(t)) - lit(_f32(0.5) * self.pitch)
        d2 = self.profile.distance(torch.stack([x, y], dim=-1))
        return torch.maximum(d2, torch.abs(pz) - lit(self.length_div2))

    def bounds(self):
        r = _f32(self.profile.bounds()[1][1])
        r = _f32(r + self.length_div2 * np.tan(self.taper, dtype=_f32))
        L = self.length_div2
        return _box([-r, -r, -L], [r, r, L])


class Pinned:
    """A part whose bounding box is fixed, whatever its dimensions: the
    region an edit loop renders in."""

    def __init__(self, s, box):
        self.s, self.box = s, _box(*box)

    def distance(self, p):
        return self.s.distance(p)

    def bounds(self):
        return self.box


# --- the box arithmetic of the flat renderer's grid ------------------------
def scale_centered(box, f):
    lo, hi = box
    f = _f32(f)
    c = ((lo + hi) * _f32(0.5)).astype(_f32)
    return _box((lo - c) * f + c, (hi - c) * f + c)


def diagonal(box) -> float:
    """The box's diagonal in float32 steps."""
    s = (box[1] - box[0]).astype(_f32)
    acc = _f32(0)
    for c in s:
        acc = _f32(acc + _f32(c * c))
    return float(np.sqrt(acc, dtype=_f32))


# --- polygon construction: corners rounded by a circular fillet -----------
def fillet(a, b, c, radius: float, facets: int):
    """The points of a circular fillet of `radius` at corner b between the
    edges to a and to c, `facets` segments (facets + 1 points), in float64;
    the corner itself where the radius does not fit."""
    v0 = (a[0] - b[0], a[1] - b[1])
    v1 = (c[0] - b[0], c[1] - b[1])
    l0, l1 = math.hypot(*v0), math.hypot(*v1)
    u0 = (v0[0] / l0, v0[1] / l0)
    u1 = (v1[0] / l1, v1[1] / l1)
    theta = math.acos(max(-1.0, min(1.0, u0[0] * u1[0] + u0[1] * u1[1])))
    if theta < 1e-9 or abs(theta - math.pi) < 1e-9:
        return [b]
    tangent = radius / math.tan(theta / 2)
    if tangent > l0 or tangent > l1:
        return [b]
    to_centre = radius / math.sin(theta / 2)
    bis = (u0[0] + u1[0], u0[1] + u1[1])
    bl = math.hypot(*bis)
    centre = (b[0] + bis[0] / bl * to_centre, b[1] + bis[1] / bl * to_centre)
    t0 = (b[0] + u0[0] * tangent, b[1] + u0[1] * tangent)
    t1 = (b[0] + u1[0] * tangent, b[1] + u1[1] * tangent)
    a0 = math.atan2(t0[1] - centre[1], t0[0] - centre[0])
    a1 = math.atan2(t1[1] - centre[1], t1[0] - centre[0])
    sweep = a1 - a0
    if sweep > math.pi:
        sweep -= 2 * math.pi
    elif sweep < -math.pi:
        sweep += 2 * math.pi
    return [(centre[0] + radius * math.cos(a0 + sweep * i / facets),
             centre[1] + radius * math.sin(a0 + sweep * i / facets)) for i in range(facets + 1)]


def polygon_vertices(corners) -> np.ndarray:
    """(V, 2) float32 vertices of a closed polygon from corners given as
    (x, y) or (x, y, fillet radius, facets)."""
    pts = [tuple(float(v) for v in c[:2]) for c in corners]
    out = []
    n = len(corners)
    for i, c in enumerate(corners):
        if len(c) > 2 and c[2] > 0:
            out += fillet(pts[i - 1], pts[i], pts[(i + 1) % n], float(c[2]), int(c[3]))
        else:
            out.append(pts[i])
    dedup = []
    for q in out:
        if not dedup or abs(q[0] - dedup[-1][0]) > 1e-12 or abs(q[1] - dedup[-1][1]) > 1e-12:
            dedup.append(q)
    if len(dedup) > 1 and dedup[0] == dedup[-1]:
        dedup.pop()
    return np.array(dedup, _f32)
