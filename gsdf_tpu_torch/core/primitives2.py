"""2D primitives of the ported slice (gsdf_tpu/core/primitives2.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.boxes import Box
from . import mathx as mx
from .node import Shader2D

_f32 = np.float32


class Polygon2D(Shader2D):
    """Winding-number polygon (cpu_evaluators.go:793, primitives2d.go:459;
    https://www.shadertoy.com/view/wdBXRW).

    One fold over the edges, in the arithmetic of the JAX package's edge
    scan (primitives2.py:354-389); its broadcast branch for small polygons
    computes the same values. min and the flip count are
    order-independent."""

    PARAMS = ("vert",)

    def __init__(self, vertices):
        self.vert = np.asarray(vertices, dtype=_f32).reshape(-1, 2)

    def _edges(self) -> np.ndarray:
        """(V,4) float32 rows v1x v1y v2x v2y; v2 is the previous vertex."""
        return np.concatenate(
            [self.vert, np.roll(self.vert, 1, axis=0)], axis=1
        ).astype(_f32)

    def distance(self, p):
        px = p[..., 0]
        py = p[..., 1]
        d = torch.full(px.shape, float("inf"), dtype=torch.float32, device=p.device)
        nflips = torch.zeros(px.shape, dtype=torch.int32, device=p.device)
        for v1x, v1y, v2x, v2y in self._edges():
            ex, ey = v2x - v1x, v2y - v1y  # float32, as the scan computes them
            ee = ex * ex + ey * ey
            wx = px - mx.lit(v1x)
            wy = py - mx.lit(v1y)
            h = mx.clamp(mx.div(wx * mx.lit(ex) + wy * mx.lit(ey), ee), 0.0, 1.0)
            bx = wx - h * mx.lit(ex)
            by = wy - h * mx.lit(ey)
            d = torch.minimum(d, bx * bx + by * by)
            b1 = py >= mx.lit(v1y)
            b2 = py < mx.lit(v2y)
            b3 = mx.lit(ex) * wy > mx.lit(ey) * wx
            flip = (b1 & b2 & b3) | (~b1 & ~b2 & ~b3)
            nflips = nflips + flip.to(torch.int32)
        s = torch.where(nflips % 2 == 1, -1.0, 1.0).to(torch.float32)
        return s * torch.sqrt(d)

    def emit_cuda(self, cg) -> str:
        edges = self._edges()
        arr = cg.array(self, edges)
        return (
            "float d = INFINITY;\n"
            "int nflips = 0;\n"
            f"for (int e = 0; e < {len(edges)}; ++e) {{\n"
            f"    const float* v = {arr} + 4 * e;\n"
            "    float ex = v[2] - v[0];\n"
            "    float ey = v[3] - v[1];\n"
            "    float wx = px - v[0];\n"
            "    float wy = py - v[1];\n"
            "    float ee = ex * ex + ey * ey;\n"
            "    float h = fminf(fmaxf((wx * ex + wy * ey) / ee, 0.0f), 1.0f);\n"
            "    float bx = wx - h * ex;\n"
            "    float by = wy - h * ey;\n"
            "    d = fminf(d, bx * bx + by * by);\n"
            "    bool b1 = py >= v[1];\n"
            "    bool b2 = py < v[3];\n"
            "    bool b3 = ex * wy > ey * wx;\n"
            "    nflips += ((b1 && b2 && b3) || (!b1 && !b2 && !b3)) ? 1 : 0;\n"
            "}\n"
            "return ((nflips % 2 == 1) ? -1.0f : 1.0f) * sqrtf(d);"
        )

    def bounds(self) -> Box:
        return Box(self.vert.min(axis=0), self.vert.max(axis=0))


class BuilderPrimitives2:
    """2D primitive constructors with reference validation rules."""

    def new_polygon(self, vertices) -> Shader2D:
        vertices = np.asarray(vertices, dtype=_f32).reshape(-1, 2)
        vertices = self._validate_polygon(vertices)
        return Polygon2D(vertices)

    def _validate_polygon(self, vertices: np.ndarray) -> np.ndarray:
        # reference primitives2d.go:471-490
        if len(vertices) and np.array_equal(vertices[0], vertices[-1]):
            vertices = vertices[:-1]
        if len(vertices) < 3:
            self.shape_error("polygon needs at least 3 distinct vertices")
            return vertices
        if np.any(np.isnan(vertices)):
            self.shape_error("NaN value in vertices")
        prev = len(vertices) - 1
        for i in range(len(vertices)):
            if np.array_equal(vertices[i], vertices[prev]):
                self.shape_error("found two consecutive equal vertices in polygon")
            prev = i
        return vertices
