"""2D primitives (gsdf_tpu/core/primitives2.py).

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:551-818; primitives2d.go:14-700). The JAX package's
branchy algorithms (ellipse, exact bezier, arc) select per point with
jnp.where; the torch versions do the same with torch.where, and the
generated C computes both branches and selects, so every branch rounds
as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.boxes import Box
from . import mathx as mx
from .node import NO_BOUND, Shader2D, finite

_f32 = np.float32


class Circle(Shader2D):
    """(cpu_evaluators.go:661, primitives2d.go:228)."""

    PARAMS = ("r",)
    CONT_PARAMS = ("r",)

    def __init__(self, r):
        self.r = _f32(r)

    def distance(self, p):
        return mx.length(p) - mx.lit(self.r)

    def emit_cuda(self, cg) -> str:
        return f"return sqrtf(px * px + py * py) - {cg.p(self, 'r')};"

    # sqrtf(...) >= 0, so the result >= fl(0 - r) = -r (as Sphere's)
    def lower_bound(self):
        return -self.r if finite(self.r) else NO_BOUND

    def nan_free(self):
        return finite(self.r)

    def bounds(self) -> Box:
        r = self.r
        return Box(np.array([-r, -r], _f32), np.array([r, r], _f32))


class Line2D(Shader2D):
    """Thick segment (cpu_evaluators.go:551, primitives2d.go:15)."""

    PARAMS = ("a", "b", "width")

    def __init__(self, a, b, width):
        self.a = np.asarray(a, dtype=_f32)
        self.b = np.asarray(b, dtype=_f32)
        self.width = _f32(width)

    def _consts(self):
        ba = self.b - self.a
        # a float32 dot product on the host, as the JAX package takes it
        return ba, float(np.dot(self.b - self.a, self.b - self.a)), self.width / _f32(2)

    def distance(self, p):
        ba, dotba, w = self._consts()
        pa = p - mx.const(self.a, p)
        h = mx.clamp(mx.div(mx.dot(pa, mx.const(ba, p)), dotba), 0.0, 1.0)
        return mx.length(pa - h[..., None] * mx.const(ba, p)) - mx.lit(w)

    def emit_cuda(self, cg) -> str:
        ba, dotba, w = self._consts()
        ax, ay = (cg.lit(v) for v in self.a)
        bx, by = (cg.lit(v) for v in ba)
        return (
            f"float pax = px - {ax}, pay = py - {ay};\n"
            f"float h = gsdf_clamp((pax * {bx} + pay * {by}) / {cg.lit(dotba)}, 0.0f, 1.0f);\n"
            f"float vx = pax - h * {bx}, vy = pay - h * {by};\n"
            f"return sqrtf(vx * vx + vy * vy) - {cg.lit(w)};"
        )

    def bounds(self) -> Box:
        w = self.width / 2
        lo = np.minimum(self.a, self.b) - w
        hi = np.maximum(self.a, self.b) + w
        return Box(lo, hi)


class Lines2D(Shader2D):
    """Batch of thick segments, min-reduced (cpu_evaluators.go:1145,
    primitives2d.go:70). One fold over a (S,5) table of rows
    ax ay bax bay |ba|^2; min is order-independent."""

    PARAMS = ("points", "width")

    def __init__(self, points, width):
        self.points = np.asarray(points, dtype=_f32).reshape(-1, 2, 2)
        self.width = _f32(width)

    def _table(self) -> np.ndarray:
        a = self.points[:, 0, :]
        ba = self.points[:, 1, :] - a
        dotba = ba[:, 0] * ba[:, 0] + ba[:, 1] * ba[:, 1]
        return np.concatenate([a, ba, dotba[:, None]], axis=1).astype(_f32)

    def distance(self, p):
        px, py = p[..., 0], p[..., 1]
        d2 = torch.full(px.shape, float("inf"), dtype=torch.float32, device=p.device)
        for ax, ay, bx, by, dotba in self._table():
            pax = px - mx.lit(ax)
            pay = py - mx.lit(ay)
            h = mx.clamp(mx.div(pax * mx.lit(bx) + pay * mx.lit(by), dotba), 0.0, 1.0)
            vx = pax - h * mx.lit(bx)
            vy = pay - h * mx.lit(by)
            d2 = torch.minimum(d2, vx * vx + vy * vy)
        d2 = torch.clamp(d2, max=mx.lit(1e23))
        return mx.sqrt(d2) - mx.lit(self.width / _f32(2))

    def emit_cuda(self, cg) -> str:
        table = self._table()
        arr = cg.array(self, table)
        return (
            "float d2 = INFINITY;\n"
            f"for (int s = 0; s < {len(table)}; ++s) {{\n"
            f"    const float* v = {arr} + 5 * s;\n"
            "    float pax = px - v[0], pay = py - v[1];\n"
            "    float h = gsdf_clamp((pax * v[2] + pay * v[3]) / v[4], 0.0f, 1.0f);\n"
            "    float vx = pax - h * v[2], vy = pay - h * v[3];\n"
            "    d2 = fminf(d2, vx * vx + vy * vy);\n"
            "}\n"
            f"d2 = fminf({cg.lit(1e23)}, d2);\n"
            f"return sqrtf(d2) - {cg.lit(self.width / _f32(2))};"
        )

    def bounds(self) -> Box:
        pts = self.points.reshape(-1, 2)
        w = self.width / 2
        return Box(pts.min(axis=0) - w, pts.max(axis=0) + w)


class Arc2D(Shader2D):
    """(cpu_evaluators.go:564, primitives2d.go:176)."""

    PARAMS = ("radius", "angle", "thick")

    def __init__(self, radius, angle, thick):
        self.radius = _f32(radius)
        self.angle = _f32(angle)
        self.thick = _f32(thick)

    def _consts(self):
        r = self.radius
        s = _f32(math.sin(float(self.angle) / 2))
        c = _f32(math.cos(float(self.angle) / 2))
        return r, self.thick / _f32(2), s, c, r * s, r * c

    def distance(self, p):
        r, t, s, c, rs, rc = (mx.lit(v) for v in self._consts())
        px = torch.abs(p[..., 0])
        py = p[..., 1]
        d_end = mx.hypot(px - rs, py - rc) - t
        d_arc = torch.abs(mx.hypot(px, py) - r) - t
        return torch.where(c * px > s * py, d_end, d_arc)

    def emit_cuda(self, cg) -> str:
        r, t, s, c, rs, rc = (cg.lit(v) for v in self._consts())
        return (
            "float ax = fabsf(px);\n"
            f"float ex = ax - {rs}, ey = py - {rc};\n"
            f"float d_end = sqrtf(ex * ex + ey * ey) - {t};\n"
            f"float d_arc = fabsf(sqrtf(ax * ax + py * py) - {r}) - {t};\n"
            f"return ({c} * ax > {s} * py) ? d_end : d_arc;"
        )

    def bounds(self) -> Box:
        r = self.radius + self.thick
        rcos = self.radius * _f32(math.cos(float(self.angle) / 2)) - self.thick
        return Box(np.array([-r, rcos], _f32), np.array([r, r], _f32))


class EquilateralTriangle(Shader2D):
    """(cpu_evaluators.go:669, primitives2d.go:266)."""

    PARAMS = ("h_tri",)
    CONT_PARAMS = ("h_tri",)

    def __init__(self, h_tri):
        self.h_tri = _f32(h_tri)

    def _consts(self):
        k = _f32(mx.SQRT3)
        r = self.h_tri / k
        return k, r, r / k, -2 * r

    def distance(self, p):
        k, r, rk, m2r = (mx.lit(v) for v in self._consts())
        px = torch.abs(p[..., 0]) - r
        py = p[..., 1] + rk
        cond = px + k * py > 0
        px2 = (px - k * py) * 0.5
        py2 = (-k * px - py) * 0.5
        px = torch.where(cond, px2, px)
        py = torch.where(cond, py2, py)
        px = px - torch.clamp(px, m2r, 0.0)
        return -mx.hypot(px, py) * mx.sign(py)

    def emit_cuda(self, cg) -> str:
        kv, rv, rkv, m2rv = self._consts()
        k, nk = cg.lit(kv), cg.lit(-kv)
        r = cg.expr(rv, f"{cg.p(self, 'h_tri')} / {k}")
        rk = cg.expr(rkv, f"{r} / {k}")
        m2r = cg.expr(m2rv, f"-2.0f * {r}")
        return (
            f"float qx = fabsf(px) - {r};\n"
            f"float qy = py + {rk};\n"
            f"if (qx + {k} * qy > 0.0f) {{\n"
            f"    float nx = (qx - {k} * qy) * 0.5f;\n"
            f"    float ny = ({nk} * qx - qy) * 0.5f;\n"
            "    qx = nx;\n"
            "    qy = ny;\n"
            "}\n"
            f"qx = qx - gsdf_clamp(qx, {m2r}, 0.0f);\n"
            "return -sqrtf(qx * qx + qy * qy) * gsdf_sign(qy);"
        )

    def bounds(self) -> Box:
        height = float(self.h_tri)
        side = height / mx.TRIBISECT
        long_bisect = side / mx.SQRT3
        short_bisect = long_bisect / 2
        return Box(
            np.array([-side / 2, -short_bisect], _f32),
            np.array([side / 2, long_bisect], _f32),
        )


class Rectangle(Shader2D):
    """(cpu_evaluators.go:685, primitives2d.go:308)."""

    PARAMS = ("d",)
    CONT_PARAMS = ("d",)

    def __init__(self, d):
        self.d = np.asarray(d, dtype=_f32)

    def distance(self, p):
        d = torch.abs(p) - mx.const(self.d * _f32(0.5), p)
        return mx.length(torch.clamp(d, min=0.0)) + torch.clamp(
            torch.maximum(d[..., 0], d[..., 1]), max=0.0
        )

    def emit_cuda(self, cg) -> str:
        bx, by = (
            cg.expr(v, f"{d} * 0.5f") for v, d in zip(self.d * _f32(0.5), cg.p(self, "d"))
        )
        return (
            f"float dx = fabsf(px) - {bx}, dy = fabsf(py) - {by};\n"
            "float ox = fmaxf(dx, 0.0f), oy = fmaxf(dy, 0.0f);\n"
            "return sqrtf(ox * ox + oy * oy) + fminf(0.0f, fmaxf(dx, dy));"
        )

    # dx = fabsf(px) - bx >= fl(0 - bx) = -bx, likewise dy, so fminf(0,
    # fmaxf(dx, dy)) >= min(0, max(-bx, -by)) = L and L + sqrtf(...) >= L
    def lower_bound(self):
        if not finite(self.d):
            return NO_BOUND
        return np.minimum(_f32(0.0), (_f32(0.0) - self.d * _f32(0.5)).max())

    def nan_free(self):
        return finite(self.d)

    def bounds(self) -> Box:
        h = self.d * _f32(0.5)
        return Box(-h, h)


class _Fold(Shader2D):
    """Regular polygons by mirror folds: Hexagon2D, Octagon2D."""

    def _fold(self, px, py, kx, ky):
        """One fold of (|p|) across the line of normal (kx, ky)."""
        m = 2 * torch.clamp(kx * px + ky * py, max=0.0)
        return px - m * kx, py - m * ky

    @staticmethod
    def _emit_fold(kx: str, ky: str, n: int) -> str:
        return (
            f"float m{n} = 2.0f * fminf({kx} * ax + {ky} * ay, 0.0f);\n"
            f"ax = ax - m{n} * {kx};\n"
            f"ay = ay - m{n} * {ky};\n"
        )

    def _tail(self, px, py, clampv, r):
        px = px - torch.clamp(px, -clampv, clampv)
        py = py - r
        return mx.sign(py) * mx.hypot(px, py)

    def _tail_args(self, cg, name: str):
        """_emit_tail's (clampv, nclampv, r) for the size parameter `name`:
        KZ * r and its negation, the literals of the host's float32
        products in baked mode."""
        r = cg.p(self, name)
        kz, rv = self.KZ, getattr(self, name)
        return (
            cg.expr(kz * rv, f"{cg.lit(kz)} * {r}"),
            cg.expr(-kz * rv, f"{cg.lit(-kz)} * {r}"),
            r,
        )

    @staticmethod
    def _emit_tail(clampv: str, nclampv: str, r: str) -> str:
        return (
            f"ax = ax - gsdf_clamp(ax, {nclampv}, {clampv});\n"
            f"ay = ay - {r};\n"
            "return gsdf_sign(ay) * sqrtf(ax * ax + ay * ay);"
        )


class Hexagon2D(_Fold):
    """(cpu_evaluators.go:718, primitives2d.go:349)."""

    PARAMS = ("side",)
    CONT_PARAMS = ("side",)
    KX, KY, KZ = _f32(-mx.TRIBISECT), _f32(0.5), _f32(0.577350269)

    def __init__(self, side):
        self.side = _f32(side)

    def distance(self, p):
        px, py = self._fold(
            torch.abs(p[..., 0]), torch.abs(p[..., 1]), mx.lit(self.KX), mx.lit(self.KY)
        )
        return self._tail(px, py, mx.lit(self.KZ * self.side), mx.lit(self.side))

    def emit_cuda(self, cg) -> str:
        return (
            "float ax = fabsf(px), ay = fabsf(py);\n"
            + self._emit_fold(cg.lit(self.KX), cg.lit(self.KY), 1)
            + self._emit_tail(*self._tail_args(cg, "side"))
        )

    def bounds(self) -> Box:
        s = float(self.side)
        w = s / mx.TRIBISECT
        return Box(np.array([-w, -s], _f32), np.array([w, s], _f32))


class Octagon2D(_Fold):
    """(cpu_evaluators.go:731, primitives2d.go:386)."""

    PARAMS = ("c",)
    CONT_PARAMS = ("c",)
    KX, KY, KZ = _f32(-0.9238795325), _f32(0.3826834323), _f32(0.4142135623)

    def __init__(self, constrain):
        self.c = _f32(constrain)

    def distance(self, p):
        kx, ky = mx.lit(self.KX), mx.lit(self.KY)
        px, py = self._fold(torch.abs(p[..., 0]), torch.abs(p[..., 1]), kx, ky)
        px, py = self._fold(px, py, -kx, ky)
        return self._tail(px, py, mx.lit(self.KZ * self.c), mx.lit(self.c))

    def emit_cuda(self, cg) -> str:
        kx, nkx, ky = cg.lit(self.KX), cg.lit(-self.KX), cg.lit(self.KY)
        return (
            "float ax = fabsf(px), ay = fabsf(py);\n"
            + self._emit_fold(kx, ky, 1)
            + self._emit_fold(nkx, ky, 2)
            + self._emit_tail(*self._tail_args(cg, "c"))
        )

    def bounds(self) -> Box:
        s = self.c
        return Box(np.array([-s, -s], _f32), np.array([s, s], _f32))


class Ellipse2D(Shader2D):
    """IQ iteration-free exact ellipse with one Newton polish
    (cpu_evaluators.go:750, primitives2d.go:422;
    https://iquilezles.org/articles/ellipsedist)."""

    PARAMS = ("a", "b")
    CONT_PARAMS = ("a", "b")

    def __init__(self, a, b):
        self.a = _f32(a)
        self.b = _f32(b)

    def distance(self, p):
        px = torch.abs(p[..., 0])
        py = torch.abs(p[..., 1])
        swap = px > py
        sx = torch.where(swap, py, px)
        sy = torch.where(swap, px, py)
        a = torch.where(swap, mx.lit(self.b), mx.lit(self.a))
        b = torch.where(swap, mx.lit(self.a), mx.lit(self.b))

        l = b * b - a * a
        m = a * sx / l
        m2 = m * m
        n = b * sy / l
        n2 = n * n
        c = mx.div(m2 + n2 - 1, 3.0)
        c3 = c * c * c
        q = c3 + 2 * m2 * n2
        d = c3 + m2 * n2
        g = m + m * n2

        # branch d < 0 (3 real roots)
        h_acos = mx.div(mx.acos(torch.clamp(q / c3, -1.0, 1.0)), 3.0)
        sh = mx.sin(h_acos)
        ch = mx.cos(h_acos)
        t_ = mx.lit(mx.SQRT3) * sh
        rx_a = mx.sqrt(torch.clamp(-c * (ch + t_ + 2) + m2, min=0.0))
        ry_a = mx.sqrt(torch.clamp(-c * (ch - t_ + 2) + m2, min=0.0))
        co_a = mx.div(ry_a + mx.sign(l) * rx_a + torch.abs(g) / (rx_a * ry_a) - m, 2.0)

        # branch d >= 0 (1 real root)
        h_ = 2 * m * n * mx.sqrt(torch.clamp(d, min=0.0))
        s_ = mx.sign(q + h_) * mx.cbrt(torch.abs(q + h_))
        u_ = mx.sign(q - h_) * mx.cbrt(torch.abs(q - h_))
        rx_b = -s_ - u_ - 4 * c + 2 * m2
        ry_b = mx.lit(mx.SQRT3) * (s_ - u_)
        rm = mx.hypot(rx_b, ry_b)
        co_b = mx.div(
            ry_b / mx.sqrt(torch.clamp(rm - rx_b, min=mx.lit(1e-38))) + 2 * g / rm - m, 2.0
        )

        co = torch.where(d < 0, co_a, co_b)
        co = torch.clamp(co, 0.0, 1.0)
        si = mx.sqrt(torch.clamp(1 - co * co, min=0.0))
        # one trig-free Newton polish on the closest-point angle
        # (gsdf_tpu/core/primitives2.py:287-301)
        gg = (b * b - a * a) * si * co + a * sx * si - b * sy * co
        gp = (b * b - a * a) * (co * co - si * si) + a * sx * co + b * sy * si
        delta = torch.where(torch.abs(gp) > mx.lit(1e-30), gg / gp, 0.0)
        delta = torch.clamp(delta, -0.5, 0.5)
        c_new = co + delta * si
        s_new = si - delta * co
        inv = mx.div(1.0, mx.hypot(c_new, s_new))
        co = torch.clamp(c_new * inv, 0.0, 1.0)
        si = mx.sqrt(torch.clamp(1 - co * co, min=0.0))
        rx = a * co
        ry = b * si
        return mx.hypot(rx - sx, ry - sy) * mx.sign(sy - ry)

    def emit_cuda(self, cg) -> str:
        A, B = cg.p(self, "a"), cg.p(self, "b")
        sqrt3 = cg.lit(mx.SQRT3)
        return (
            "float ax = fabsf(px), ay = fabsf(py);\n"
            "bool swap = ax > ay;\n"
            "float sx = swap ? ay : ax, sy = swap ? ax : ay;\n"
            f"float a = swap ? {B} : {A}, b = swap ? {A} : {B};\n"
            "float l = b * b - a * a;\n"
            "float m = a * sx / l, m2 = m * m;\n"
            "float n = b * sy / l, n2 = n * n;\n"
            "float c = (m2 + n2 - 1.0f) / 3.0f, c3 = c * c * c;\n"
            "float q = c3 + 2.0f * m2 * n2;\n"
            "float d = c3 + m2 * n2;\n"
            "float g = m + m * n2;\n"
            "float h_acos = acosf(gsdf_clamp(q / c3, -1.0f, 1.0f)) / 3.0f;\n"
            "float sh = sinf(h_acos), ch = cosf(h_acos);\n"
            f"float t_ = {sqrt3} * sh;\n"
            "float rx_a = sqrtf(fmaxf(-c * (ch + t_ + 2.0f) + m2, 0.0f));\n"
            "float ry_a = sqrtf(fmaxf(-c * (ch - t_ + 2.0f) + m2, 0.0f));\n"
            "float co_a = (ry_a + gsdf_sign(l) * rx_a + fabsf(g) / (rx_a * ry_a) - m) / 2.0f;\n"
            "float h_ = 2.0f * m * n * sqrtf(fmaxf(d, 0.0f));\n"
            "float s_ = gsdf_sign(q + h_) * gsdf_cbrt(fabsf(q + h_));\n"
            "float u_ = gsdf_sign(q - h_) * gsdf_cbrt(fabsf(q - h_));\n"
            "float rx_b = -s_ - u_ - 4.0f * c + 2.0f * m2;\n"
            f"float ry_b = {sqrt3} * (s_ - u_);\n"
            "float rm = sqrtf(rx_b * rx_b + ry_b * ry_b);\n"
            f"float co_b = (ry_b / sqrtf(fmaxf(rm - rx_b, {cg.lit(1e-38)})) + 2.0f * g / rm - m)"
            " / 2.0f;\n"
            "float co = gsdf_clamp(d < 0.0f ? co_a : co_b, 0.0f, 1.0f);\n"
            "float si = sqrtf(fmaxf(1.0f - co * co, 0.0f));\n"
            "float gg = (b * b - a * a) * si * co + a * sx * si - b * sy * co;\n"
            "float gp = (b * b - a * a) * (co * co - si * si) + a * sx * co + b * sy * si;\n"
            f"float delta = fabsf(gp) > {cg.lit(1e-30)} ? gg / gp : 0.0f;\n"
            "delta = gsdf_clamp(delta, -0.5f, 0.5f);\n"
            "float c_new = co + delta * si, s_new = si - delta * co;\n"
            "float inv = 1.0f / sqrtf(c_new * c_new + s_new * s_new);\n"
            "co = gsdf_clamp(c_new * inv, 0.0f, 1.0f);\n"
            "si = sqrtf(fmaxf(1.0f - co * co, 0.0f));\n"
            "float ex = a * co - sx, ey = b * si - sy;\n"
            "return sqrtf(ex * ex + ey * ey) * gsdf_sign(sy - b * si);"
        )

    def bounds(self) -> Box:
        a, b = self.a, self.b
        return Box(np.array([-a, -b], _f32), np.array([a, b], _f32))


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
        return s * mx.sqrt(d)

    def _edge_rows(self) -> np.ndarray:
        """(V, 8) float32 rows v1x v1y ex ey ee v2y 0 0, one an edge: ex,
        ey and ee by `distance`'s own float32 expressions; 32 bytes a row,
        two 16-byte loads."""
        v1x, v1y, v2x, v2y = self._edges().T
        with np.errstate(over="ignore", under="ignore"):
            ex, ey = v2x - v1x, v2y - v1y
            ee = ex * ex + ey * ey
        zero = np.zeros_like(ex)
        return np.stack([v1x, v1y, ex, ey, ee, v2y, zero, zero], axis=1)

    def emit_cuda(self, cg) -> str:
        """`distance`'s fold, bit for bit, with the division only where
        the clamp does not decide h. With num = wx ex + wy ey, `distance`
        takes h = clamp(num / ee, 0, 1), and h enters the result only
        through bx = wx - h ex and by = wy - h ey, squared:
        - num <= 0 or NaN: the quotient is <= 0 or NaN (x / 0 = -inf, 0 /
          0 and NaN / x are NaN), which fmaxf(q, 0) takes to +-0; h = 0
          gives the same squares (h ex is +-0 either way);
        - num > 0 and num >= ee, ee finite: ee = 0 gives num / 0 = +inf,
          and ee > 0 a quotient >= 1 (1 is a float and rounding is
          monotone): h = 1;
        - else (0 < num < ee): today's expression, division and clamp.
        ee is never NaN (a sum of squares). An edge whose ee overflows to
        +inf has h = 0 for every num (num / inf is +-0, or NaN where num
        is +-inf), so a polygon with one divides wherever num > 0. The
        flip test is b1 == b2 == b3, the same boolean as (b1 b2 b3) or
        (!b1 !b2 !b3). A warp whose lanes all project outside an edge
        runs no division there."""
        rows = self._edge_rows()
        arr = cg.array(self, rows, align=32)
        k = cg.edge_loop(self, len(rows))
        inside = "num < ee" if np.isfinite(rows[:, 4]).all() else "(num < ee || isinf(ee))"
        return (
            "float d = INFINITY;\n"
            "int nflips = 0;\n"
            f"GSDF_EDGES({k});\n"
            f"for (int e = 0; e < {len(rows)}; ++e) {{\n"
            f"    const float* v = {arr} + 8 * e;\n"
            "    const float wx = px - v[0];\n"
            "    const float wy = py - v[1];\n"
            "    const float ex = v[2], ey = v[3], ee = v[4];\n"
            "    const float num = wx * ex + wy * ey;\n"
            "    float h = num > 0.0f ? 1.0f : 0.0f;\n"
            f"    if (GSDF_EDGE({k}, num > 0.0f && {inside})) h = fminf(fmaxf(num / ee, 0.0f), 1.0f);\n"
            "    const float bx = wx - h * ex;\n"
            "    const float by = wy - h * ey;\n"
            "    d = fminf(d, bx * bx + by * by);\n"
            "    const bool b1 = py >= v[1], b2 = py < v[5], b3 = ex * wy > ey * wx;\n"
            "    nflips += (b1 == b2 && b2 == b3) ? 1 : 0;\n"
            "}\n"
            f"GSDF_EDGES_DONE({k}, {len(rows)});\n"
            "return ((nflips % 2 == 1) ? -1.0f : 1.0f) * sqrtf(d);"
        )

    def bounds(self) -> Box:
        return Box(self.vert.min(axis=0), self.vert.max(axis=0))


class Diamond2D(Shader2D):
    """(cpu_evaluators.go:694, primitives2d.go:561)."""

    PARAMS = ("d",)
    CONT_PARAMS = ("d",)

    def __init__(self, d):
        self.d = np.asarray(d, dtype=_f32)

    def _consts(self):
        b = self.d * _f32(0.5)
        return b[0], b[1], b[0] * b[0] + b[1] * b[1], _f32(0.5) * b[0], _f32(0.5) * b[1], b[0] * b[1]

    def distance(self, p):
        b0, b1, bb, hb0, hb1, b01 = (mx.lit(v) for v in self._consts())
        ax = torch.abs(p[..., 0])
        ay = torch.abs(p[..., 1])
        h = mx.clamp(mx.div((b0 - 2 * ax) * b0 - (b1 - 2 * ay) * b1, bb), -1.0, 1.0)
        qx = ax - hb0 * (1 - h)
        qy = ay - hb1 * (1 + h)
        return mx.hypot(qx, qy) * mx.sign(ax * b1 + ay * b0 - b01)

    def emit_cuda(self, cg) -> str:
        v = self._consts()
        dx, dy = cg.p(self, "d")
        b0 = cg.expr(v[0], f"{dx} * 0.5f")
        b1 = cg.expr(v[1], f"{dy} * 0.5f")
        bb = cg.expr(v[2], f"{b0} * {b0} + {b1} * {b1}")
        hb0 = cg.expr(v[3], f"0.5f * {b0}")
        hb1 = cg.expr(v[4], f"0.5f * {b1}")
        b01 = cg.expr(v[5], f"{b0} * {b1}")
        return (
            "float ax = fabsf(px), ay = fabsf(py);\n"
            f"float h = gsdf_clamp(((({b0} - 2.0f * ax) * {b0}) - (({b1} - 2.0f * ay) * {b1}))"
            f" / {bb}, -1.0f, 1.0f);\n"
            f"float qx = ax - {hb0} * (1.0f - h);\n"
            f"float qy = ay - {hb1} * (1.0f + h);\n"
            f"return sqrtf(qx * qx + qy * qy) * gsdf_sign(ax * {b1} + ay * {b0} - {b01});"
        )

    def bounds(self) -> Box:
        h = self.d * _f32(0.5)
        return Box(-h, h)


class RoundedX2D(Shader2D):
    """(cpu_evaluators.go:705, primitives2d.go:603)."""

    PARAMS = ("dim", "thick")
    CONT_PARAMS = ("dim", "thick")

    def __init__(self, width, thick):
        self.dim = _f32(width)
        self.thick = _f32(thick)

    def distance(self, p):
        ax = torch.abs(p[..., 0])
        ay = torch.abs(p[..., 1])
        sub = 0.5 * torch.clamp(ax + ay, max=mx.lit(self.dim))
        return mx.hypot(ax - sub, ay - sub) - mx.lit(self.thick)

    def emit_cuda(self, cg) -> str:
        return (
            "float ax = fabsf(px), ay = fabsf(py);\n"
            f"float sub = 0.5f * fminf(ax + ay, {cg.p(self, 'dim')});\n"
            "float ex = ax - sub, ey = ay - sub;\n"
            f"return sqrtf(ex * ex + ey * ey) - {cg.p(self, 'thick')};"
        )

    def bounds(self) -> Box:
        xd2 = self.dim / 2 + self.thick
        return Box(np.array([-xd2, -xd2], _f32), np.array([xd2, xd2], _f32))


class QuadraticBezier2D(Shader2D):
    """IQ exact quadratic bezier with cancellation-safe branch
    (cpu_evaluators.go:581-659, primitives2d.go:644)."""

    PARAMS = ("a", "b", "c", "thick")

    def __init__(self, a, b, c, thick):
        self.a = np.asarray(a, dtype=_f32)
        self.b = np.asarray(b, dtype=_f32)
        self.c = np.asarray(c, dtype=_f32)
        self.thick = _f32(thick)

    def _consts(self):
        """Host float32 constants, computed as the JAX package does."""
        A, B, C = self.a, self.b, self.c
        a_np = B - A
        a2 = _f32(np.dot(a_np, a_np))
        b_np = A + C - 2 * B
        c_np = 2 * a_np
        kk = _f32(1.0) / _f32(np.dot(b_np, b_np))
        kx = kk * _f32(np.dot(a_np, b_np))
        return dict(
            A=A, av=a_np, bv=b_np, cv=c_np, a2x2=2 * a2, kk=kk, kx=kx,
            kx2=kx * kx, kx2x2=2 * (kx * kx), thick=self.thick / _f32(2),
        )

    def distance(self, p):
        k = self._consts()
        L = {n: mx.lit(k[n]) for n in ("a2x2", "kk", "kx", "kx2", "kx2x2", "thick")}
        (ax, ay), (bx, by), (cx, cy) = ([mx.lit(v) for v in k[n]] for n in ("av", "bv", "cv"))
        dx = mx.lit(k["A"][0]) - p[..., 0]
        dy = mx.lit(k["A"][1]) - p[..., 1]
        ky = mx.div(L["kk"] * (L["a2x2"] + (dx * bx + dy * by)), 3.0)
        kz = L["kk"] * (dx * ax + dy * ay)
        g = ky - L["kx2"]
        q = L["kx"] * (L["kx2x2"] - 3 * ky) + kz
        g3 = g * g * g
        q2 = q * q
        h = q2 + 4 * g3

        # --- 1 root branch (h >= 0) ----------------------------------
        hs = mx.sqrt(torch.clamp(h, min=0.0))
        x0 = 0.5 * (-q + hs)
        x1 = 0.5 * (-q - hs)
        # cancellation-safe quadratic-Taylor variant when |g| small
        k_safe = (1.0 - g3 / q2) * g3 / q
        small = torch.abs(g) < mx.lit(0.001)
        x0 = torch.where(small, k_safe, x0)
        x1 = torch.where(small, -k_safe - q, x1)
        t = mx.sign(x0) * mx.cbrt(torch.abs(x0)) + mx.sign(x1) * mx.cbrt(torch.abs(x1))
        # single newton iteration for cancellation (NinjaKoala)
        t = t - (t * (t * t + 3.0 * g) + q) / (3.0 * t * t + 3.0 * g)
        t = torch.clamp(t - L["kx"], 0.0, 1.0)
        wx = dx + t * (cx + t * bx)
        wy = dy + t * (cy + t * by)
        res1 = wx * wx + wy * wy

        # --- 3 roots branch (h < 0) ----------------------------------
        z = mx.sqrt(torch.clamp(-g, min=0.0))
        mm = mx.cos_acos_3(q / (2 * g * z))
        nn = mx.sqrt(torch.clamp(1 - mm * mm, min=0.0)) * mx.lit(mx.SQRT3)
        res3 = None
        for tt in (
            torch.clamp((mm + mm) * z - L["kx"], 0.0, 1.0),
            torch.clamp((-nn - mm) * z - L["kx"], 0.0, 1.0),
        ):
            ex = dx + tt * (cx + tt * bx)
            ey = dy + tt * (cy + tt * by)
            dd = ex * ex + ey * ey
            res3 = dd if res3 is None else torch.minimum(res3, dd)

        res = torch.where(h >= 0, res1, res3)
        return mx.sqrt(res) - L["thick"]

    def emit_cuda(self, cg) -> str:
        k = self._consts()
        L = {n: cg.lit(k[n]) for n in ("a2x2", "kk", "kx", "kx2", "kx2x2", "thick")}
        (ax, ay), (bx, by), (cx, cy) = ([cg.lit(v) for v in k[n]] for n in ("av", "bv", "cv"))
        Ax, Ay = (cg.lit(v) for v in k["A"])
        sqdist = (
            "float e{n}x = dx + {t} * ({cx} + {t} * {bx});\n"
            "float e{n}y = dy + {t} * ({cy} + {t} * {by});\n"
            "float r{n} = e{n}x * e{n}x + e{n}y * e{n}y;\n"
        )
        return (
            f"float dx = {Ax} - px, dy = {Ay} - py;\n"
            f"float ky = {L['kk']} * ({L['a2x2']} + (dx * {bx} + dy * {by})) / 3.0f;\n"
            f"float kz = {L['kk']} * (dx * {ax} + dy * {ay});\n"
            f"float g = ky - {L['kx2']};\n"
            f"float q = {L['kx']} * ({L['kx2x2']} - 3.0f * ky) + kz;\n"
            "float g3 = g * g * g, q2 = q * q;\n"
            "float h = q2 + 4.0f * g3;\n"
            "float hs = sqrtf(fmaxf(h, 0.0f));\n"
            "float x0 = 0.5f * (-q + hs), x1 = 0.5f * (-q - hs);\n"
            "float k_safe = (1.0f - g3 / q2) * g3 / q;\n"
            f"if (fabsf(g) < {cg.lit(0.001)}) {{\n"
            "    x0 = k_safe;\n"
            "    x1 = -k_safe - q;\n"
            "}\n"
            "float t = gsdf_sign(x0) * gsdf_cbrt(fabsf(x0)) + gsdf_sign(x1) * gsdf_cbrt(fabsf(x1));\n"
            "t = t - (t * (t * t + 3.0f * g) + q) / (3.0f * t * t + 3.0f * g);\n"
            f"t = gsdf_clamp(t - {L['kx']}, 0.0f, 1.0f);\n"
            + sqdist.format(n=1, t="t", cx=cx, cy=cy, bx=bx, by=by)
            + "float z = sqrtf(fmaxf(-g, 0.0f));\n"
            "float mm = gsdf_cos_acos_3(q / (2.0f * g * z));\n"
            f"float nn = sqrtf(fmaxf(1.0f - mm * mm, 0.0f)) * {cg.lit(mx.SQRT3)};\n"
            f"float tx = gsdf_clamp((mm + mm) * z - {L['kx']}, 0.0f, 1.0f);\n"
            f"float ty = gsdf_clamp((-nn - mm) * z - {L['kx']}, 0.0f, 1.0f);\n"
            + sqdist.format(n=2, t="tx", cx=cx, cy=cy, bx=bx, by=by)
            + sqdist.format(n=3, t="ty", cx=cx, cy=cy, bx=bx, by=by)
            + f"return sqrtf(h >= 0.0f ? r1 : fminf(r2, r3)) - {L['thick']};"
        )

    def bounds(self) -> Box:
        # reference primitives2d.go:648-673 (https://iquilezles.org/articles/bezierbbox)
        p0, p1, p2 = self.a, self.b, self.c
        lo = np.minimum(p0, p2)
        hi = np.maximum(p0, p2)
        if np.any(p1 < lo) or np.any(p1 > hi):
            denom = p0 + p2 - 2 * p1
            with np.errstate(divide="ignore", invalid="ignore"):
                t = np.clip((p0 - p1) / denom, 0.0, 1.0)
            t = np.nan_to_num(t, nan=0.0)
            s = 1.0 - t
            qv = s * s * p0 + 2 * s * t * p1 + t * t * p2
            lo = np.minimum(lo, qv)
            hi = np.maximum(hi, qv)
        th = self.thick / 2
        return Box((lo - th).astype(_f32), (hi + th).astype(_f32))


class BuilderPrimitives2:
    """2D primitive constructors with reference validation rules."""

    def new_circle(self, radius) -> Shader2D:
        if not (radius > 0 and not math.isinf(radius)):
            self.shape_error(f"bad circle radius: {radius:g}")
        return Circle(radius)

    def new_line2d(self, x0, y0, x1, y1, width) -> Shader2D:
        vals = (x0, y0, x1, y1, width)
        if any(math.isnan(v) for v in vals):
            self.shape_error("NaN argument to new_line2d")
        elif width < 0:
            self.shape_error("negative thickness to new_line2d")
        a = np.array([x0, y0], _f32)
        b = np.array([x1, y1], _f32)
        line_len = float(np.linalg.norm(a - b))
        if line_len < width * 1e-6 or line_len < mx.EPSTOL:
            if width == 0:
                self.shape_error("infimal line")
            return self.new_circle(width / 2)
        return Line2D(a, b, width)

    def new_lines2d(self, segments, width) -> Shader2D:
        segments = np.asarray(segments, dtype=_f32).reshape(-1, 2, 2)
        if width < 0:
            self.shape_error("negative thickness to new_lines2d")
        if len(segments) < 2:
            self.shape_error("empty or single points")
        for seg in segments[:-1]:
            if np.array_equal(seg[0], seg[1]):
                self.shape_error("superimposed points in new_lines2d")
        return Lines2D(segments, width)

    def new_arc(self, radius, arc_angle, thick) -> Shader2D:
        if not (radius > 0 and arc_angle > 0 and thick >= 0):
            self.shape_error("invalid argument to new_arc")
        if arc_angle > 2 * math.pi:
            self.shape_error("arc angle exceeds full circle")
        elif 2 * math.pi - arc_angle < mx.EPSTOL:
            arc_angle = 2 * math.pi - 1e-7
        return Arc2D(radius, arc_angle, thick)

    def new_equilateral_triangle(self, triangle_height) -> Shader2D:
        if not (triangle_height > 0 and not math.isinf(triangle_height)):
            self.shape_error("bad equilateral triangle height")
        return EquilateralTriangle(triangle_height)

    def new_rectangle(self, x, y) -> Shader2D:
        if not (x > 0 and y > 0 and not math.isinf(x) and not math.isinf(y)):
            self.shape_error("bad rectangle dimension")
        return Rectangle((x, y))

    def new_hexagon(self, side) -> Shader2D:
        if not (side > 0 and not math.isinf(side)):
            self.shape_error("bad hexagon dimension")
        return Hexagon2D(side)

    def new_octagon(self, constrain) -> Shader2D:
        if not constrain > 0:
            self.shape_error("bad octagon dimension %f", constrain)
        return Octagon2D(constrain)

    def new_ellipse(self, a, b) -> Shader2D:
        if not (a > 0 and b > 0 and not math.isinf(a) and not math.isinf(b)):
            self.shape_error(f"bad ellipse dimension (a={a}, b={b})")
        return Ellipse2D(a, b)

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

    def new_diamond2d(self, x_width, y_height) -> Shader2D:
        ok = (
            x_width > 0
            and y_height > 0
            and not math.isinf(x_width)
            and not math.isinf(y_height)
        )
        if not ok:
            self.shape_error("bad diamond dimension")
        return Diamond2D((x_width, y_height))

    def new_rounded_x(self, width, thick) -> Shader2D:
        ok = width > 0 and thick > 0 and not math.isinf(width) and not math.isinf(thick)
        if not ok:
            self.shape_error("bad x dimension")
        return RoundedX2D(width, thick)

    def new_quadratic_bezier2d(self, a, b, c, thick) -> Shader2D:
        return QuadraticBezier2D(a, b, c, thick)
