"""Host-side polygon builder with corner smoothing, chamfer and arcs.

Capability-equivalent rebuild of the PolygonBuilder the reference pulls from
soypat/geometry ms2 (used by all thread profiles, forge/threads/iso.go:50-76,
hex heads forge/threads/hexhead.go:18, and the gasket example). The vendored
source is not available, so the algorithms are implemented from the standard
construction rules:

- ``add_xy(x, y)`` appends a corner vertex; returns a handle whose
  ``smooth(r, facets)`` / ``chamfer(d)`` / ``arc(r, facets)`` mark the vertex
  for post-processing.
- ``smooth``: the corner is replaced by a circular fillet of radius ``r``
  tangent to both adjacent edges, discretized into ``facets`` segments
  (``facets+1`` points).
- ``chamfer``: the corner is cut at distance ``d`` along each adjacent edge.
- ``arc``: the straight segment *arriving* at this vertex is replaced by a
  circular arc of radius ``r`` through both endpoints (positive r bulges to
  the left of travel direction), discretized into ``facets`` segments.
- ``nagon(n, r)``: regular n-gon of circumradius ``r`` with a vertex placed
  so that a flat faces +x is NOT guaranteed; vertices start at angle pi/n so
  that edges are symmetric about the x axis (hex flats face +-x).

All math in float64, emitted as float32 — construction-time only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

_TAU = 2 * math.pi


@dataclasses.dataclass
class _Vertex:
    x: float
    y: float
    kind: str = "corner"  # corner | smooth | chamfer | arc
    radius: float = 0.0
    facets: int = 0

    def smooth(self, radius: float, facets: int) -> "_Vertex":
        """Fillet this corner with given radius and facet count."""
        self.kind = "smooth"
        self.radius = float(radius)
        self.facets = int(facets)
        return self

    def chamfer(self, d: float) -> "_Vertex":
        """Chamfer this corner cutting distance d along each edge."""
        self.kind = "chamfer"
        self.radius = float(d)
        return self

    def arc(self, radius: float, facets: int) -> "_Vertex":
        """Replace the incoming straight segment with a circular arc."""
        self.kind = "arc"
        self.radius = float(radius)
        self.facets = int(facets)
        return self


class PolygonBuilder:
    """Sequential polygon construction; vertices() resolves modifiers."""

    def __init__(self):
        self._verts: List[_Vertex] = []

    def add_xy(self, x: float, y: float) -> _Vertex:
        v = _Vertex(float(x), float(y))
        self._verts.append(v)
        return v

    def add_polar(self, r: float, theta: float) -> _Vertex:
        return self.add_xy(r * math.cos(theta), r * math.sin(theta))

    def add_relative_xy(self, dx: float, dy: float) -> _Vertex:
        """Add a vertex displaced (dx, dy) from the previous vertex."""
        if not self._verts:
            raise ValueError("add_relative_xy needs a previous vertex")
        last = self._verts[-1]
        return self.add_xy(last.x + dx, last.y + dy)

    def nagon(self, n: int, radius: float) -> None:
        """Regular n-gon of circumradius `radius`, edges symmetric about x."""
        if n < 3:
            raise ValueError("nagon needs n >= 3")
        dtheta = _TAU / n
        theta = dtheta / 2
        for _ in range(n):
            self.add_polar(radius, theta)
            theta += dtheta

    # --- resolution --------------------------------------------------
    def vertices(self) -> np.ndarray:
        """Resolve modifiers and return (V,2) float32 vertices (open list;
        consumers close the loop implicitly, as NewPolygon does)."""
        if len(self._verts) < 3:
            raise ValueError("polygon builder needs at least 3 vertices")
        # Pass 1: expand arcs (they replace the incoming segment). An arc
        # on the FIRST vertex arcs the implicit closing segment (last ->
        # first), so its intermediate points belong after the last
        # vertex — deferred to the end of the expanded list, never
        # silently degraded to a plain corner.
        expanded: List[_Vertex] = []
        deferred: List[_Vertex] = []
        n = len(self._verts)
        for i, v in enumerate(self._verts):
            if v.kind == "arc":
                prev = (
                    expanded[-1] if i > 0 and expanded else self._verts[-1]
                )
                pts = _arc_points(
                    (prev.x, prev.y), (v.x, v.y), v.radius, max(1, v.facets)
                )
                mids = [_Vertex(px, py) for (px, py) in pts[1:-1]]
                if i > 0:
                    expanded.extend(mids)
                else:
                    deferred = mids
                expanded.append(_Vertex(v.x, v.y))
            else:
                expanded.append(
                    _Vertex(v.x, v.y, v.kind, v.radius, v.facets)
                )
        expanded.extend(deferred)
        # Pass 2: smooth / chamfer corners.
        out: List[tuple] = []
        n = len(expanded)
        for i, v in enumerate(expanded):
            a = expanded[(i - 1) % n]
            c = expanded[(i + 1) % n]
            if v.kind == "smooth" and v.radius > 0:
                pts = _fillet_points((a.x, a.y), (v.x, v.y), (c.x, c.y), v.radius, max(1, v.facets))
                out.extend(pts)
            elif v.kind == "chamfer" and v.radius > 0:
                pts = _chamfer_points((a.x, a.y), (v.x, v.y), (c.x, c.y), v.radius)
                out.extend(pts)
            else:
                out.append((v.x, v.y))
        # drop immediately-repeated points
        dedup: List[tuple] = []
        for pt in out:
            if not dedup or (abs(pt[0] - dedup[-1][0]) > 1e-12 or abs(pt[1] - dedup[-1][1]) > 1e-12):
                dedup.append(pt)
        if len(dedup) > 1 and dedup[0] == dedup[-1]:
            dedup.pop()
        return np.array(dedup, dtype=np.float32)

    # Go-style alias used in ported code
    def append_vecs(self) -> np.ndarray:
        return self.vertices()


def _norm(v):
    return math.hypot(v[0], v[1])


def _fillet_points(a, b, c, radius, facets):
    """Circular fillet at corner b between edges b->a and b->c."""
    v0 = (a[0] - b[0], a[1] - b[1])
    v1 = (c[0] - b[0], c[1] - b[1])
    l0, l1 = _norm(v0), _norm(v1)
    if l0 == 0 or l1 == 0:
        return [b]
    u0 = (v0[0] / l0, v0[1] / l0)
    u1 = (v1[0] / l1, v1[1] / l1)
    cos_t = max(-1.0, min(1.0, u0[0] * u1[0] + u0[1] * u1[1]))
    theta = math.acos(cos_t)
    if theta < 1e-9 or abs(theta - math.pi) < 1e-9:
        return [b]  # degenerate corner: nothing to round
    d1 = radius / math.tan(theta / 2)  # tangent length along each edge
    if d1 > l0 or d1 > l1:
        # radius too large for adjacent edges; leave corner sharp
        return [b]
    d2 = radius / math.sin(theta / 2)  # corner-to-center distance
    bis = (u0[0] + u1[0], u0[1] + u1[1])
    bl = _norm(bis)
    bis = (bis[0] / bl, bis[1] / bl)
    center = (b[0] + bis[0] * d2, b[1] + bis[1] * d2)
    t0 = (b[0] + u0[0] * d1, b[1] + u0[1] * d1)  # tangent point on edge b->a
    t1 = (b[0] + u1[0] * d1, b[1] + u1[1] * d1)  # tangent point on edge b->c
    a0 = math.atan2(t0[1] - center[1], t0[0] - center[0])
    a1 = math.atan2(t1[1] - center[1], t1[0] - center[0])
    sweep = a1 - a0
    # choose the minor arc (fillets always sweep < pi)
    if sweep > math.pi:
        sweep -= _TAU
    elif sweep < -math.pi:
        sweep += _TAU
    pts = []
    for i in range(facets + 1):
        ang = a0 + sweep * i / facets
        pts.append((center[0] + radius * math.cos(ang), center[1] + radius * math.sin(ang)))
    return pts


def _chamfer_points(a, b, c, d):
    """Cut corner b at distance d along each adjacent edge."""
    v0 = (a[0] - b[0], a[1] - b[1])
    v1 = (c[0] - b[0], c[1] - b[1])
    l0, l1 = _norm(v0), _norm(v1)
    if l0 == 0 or l1 == 0:
        return [b]
    d0 = min(d, l0 * 0.5)
    d1 = min(d, l1 * 0.5)
    p0 = (b[0] + v0[0] / l0 * d0, b[1] + v0[1] / l0 * d0)
    p1 = (b[0] + v1[0] / l1 * d1, b[1] + v1[1] / l1 * d1)
    return [p0, p1]


def _arc_points(p0, p1, radius, facets):
    """Arc of given radius from p0 to p1 (inclusive). Positive radius bulges
    left of the travel direction p0->p1; |radius| must be >= half the chord."""
    chord = (p1[0] - p0[0], p1[1] - p0[1])
    d = _norm(chord)
    if d == 0:
        return [p0, p1]
    r = abs(radius)
    if r < d / 2:
        r = d / 2  # clamp to semicircle
    mid = ((p0[0] + p1[0]) / 2, (p0[1] + p1[1]) / 2)
    # perpendicular of travel direction; left = +90 degrees
    perp = (-chord[1] / d, chord[0] / d)
    h = math.sqrt(max(r * r - (d / 2) ** 2, 0.0))
    side = 1.0 if radius > 0 else -1.0
    # center is on the opposite side of the bulge
    center = (mid[0] - side * perp[0] * h, mid[1] - side * perp[1] * h)
    a0 = math.atan2(p0[1] - center[1], p0[0] - center[0])
    a1 = math.atan2(p1[1] - center[1], p1[0] - center[0])
    # always the minor arc: the radius sign already placed the center (and
    # hence the bulge side); sweep is the shortest angular path p0 -> p1.
    sweep = a1 - a0
    if sweep > math.pi:
        sweep -= _TAU
    elif sweep < -math.pi:
        sweep += _TAU
    pts = []
    for i in range(facets + 1):
        ang = a0 + sweep * i / facets
        pts.append((center[0] + r * math.cos(ang), center[1] + r * math.sin(ang)))
    return pts
