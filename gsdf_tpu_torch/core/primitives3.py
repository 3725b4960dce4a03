"""3D primitives (gsdf_tpu/core/primitives3.py).

Each node's `distance` maps torch (..., 3) -> (...,) float32 and its
`emit_cuda` writes the same arithmetic, in the same association, as C.
Host constants are computed in numpy float32 exactly as the JAX package
computes them; a Python float meeting a tensor rounds to float32 once, as
a JAX weak-typed scalar does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.boxes import Box
from . import mathx as mx
from .node import NO_BOUND, Shader3D, finite

_f32 = np.float32


class Sphere(Shader3D):
    """Sphere centered at origin (cpu_evaluators.go:20, primitives.go:28)."""

    PARAMS = ("r",)
    CONT_PARAMS = ("r",)

    def __init__(self, r: float):
        self.r = _f32(r)

    def distance(self, p):
        return mx.length(p) - mx.lit(self.r)

    def emit_cuda(self, cg) -> str:
        return f"return sqrtf(px * px + py * py + pz * pz) - {cg.p(self, 'r')};"

    # sqrtf(...) >= 0 (or +inf, never NaN at a non-NaN point), so
    # sqrtf(...) - r >= fl(0 - r) = -r exactly
    def lower_bound(self):
        return -self.r if finite(self.r) else NO_BOUND

    def nan_free(self):
        return finite(self.r)

    def bounds(self) -> Box:
        r = self.r
        return Box(np.array([-r, -r, -r], _f32), np.array([r, r, r], _f32))


class BoxShape(Shader3D):
    """Round-edged box (cpu_evaluators.go:28, primitives.go:65)."""

    PARAMS = ("dims", "round")
    CONT_PARAMS = ("dims", "round")

    def __init__(self, dims, round: float):
        self.dims = np.asarray(dims, dtype=_f32)
        self.round = _f32(round)

    def distance(self, p):
        q = torch.abs(p) - mx.const(self.dims * 0.5, p) + mx.lit(self.round)
        outside = mx.length(torch.clamp(q, min=0.0))
        inside = torch.clamp(
            torch.maximum(q[..., 0], torch.maximum(q[..., 1], q[..., 2])), max=0.0
        )
        return outside + inside - mx.lit(self.round)

    def emit_cuda(self, cg) -> str:
        dx, dy, dz = (
            cg.expr(v, f"{d} * 0.5f") for v, d in zip(self.dims * 0.5, cg.p(self, "dims"))
        )
        r = cg.p(self, "round")
        return (
            f"float qx = fabsf(px) - {dx} + {r};\n"
            f"float qy = fabsf(py) - {dy} + {r};\n"
            f"float qz = fabsf(pz) - {dz} + {r};\n"
            "float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);\n"
            "float outside = sqrtf(ox * ox + oy * oy + oz * oz);\n"
            "float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);\n"
            f"return outside + inside - {r};"
        )

    # q = (fabsf(p) - d) + r >= fl(fl(0 - d) + r) = fl(r - d) per axis, d
    # the half size; inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0) >=
    # min(max over the axes of fl(r - d), 0) = L; outside >= 0, so
    # outside + inside >= fl(0 + L) = L and the result >= fl(L - r). No
    # step makes a NaN at a non-NaN point (inf - d, sqrtf(inf) are not)
    def lower_bound(self):
        if not finite(self.dims, self.round):
            return NO_BOUND
        q = (_f32(0.0) - self.dims * _f32(0.5)) + self.round
        return np.minimum(q.max(), _f32(0.0)) - self.round

    def nan_free(self):
        return finite(self.dims, self.round)

    def bounds(self) -> Box:
        return Box.centered(np.zeros(3, _f32), self.dims)


class BoxFrame(Shader3D):
    """Framed box of beam half-thickness e (cpu_evaluators.go:38, primitives.go:254)."""

    PARAMS = ("dims", "e")
    CONT_PARAMS = ("dims", "e")

    def __init__(self, dims, e: float):
        self.dims = np.asarray(dims, dtype=_f32)
        self.e = _f32(e)  # already halved by the builder

    def _args(self):
        # reference primitives.go:292-297
        e = self.e
        b = self.dims * _f32(0.5) - 2 * e
        return e, b

    def distance(self, p):
        e, b = self._args()
        p = torch.abs(p) - mx.const(b, p)
        q = torch.abs(p + mx.lit(e)) - mx.lit(e)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]

        def seg(a, b_, c):
            s = torch.clamp(torch.maximum(a, torch.maximum(b_, c)), max=0.0)
            v = torch.stack([torch.clamp(x, min=0.0) for x in (a, b_, c)], dim=-1)
            return mx.length(v) + s

        n1 = seg(px, qy, qz)
        n2 = seg(qx, py, qz)
        n3 = seg(qx, qy, pz)
        return torch.minimum(n1, torch.minimum(n2, n3))

    def emit_cuda(self, cg) -> str:
        e = cg.p(self, "e")
        bx, by, bz = (
            cg.expr(v, f"{d} * 0.5f - 2.0f * {e}")
            for v, d in zip(self._args()[1], cg.p(self, "dims"))
        )
        seg = (
            "float s{n} = fminf(0.0f, fmaxf({a}, fmaxf({b}, {c})));\n"
            "float a{n} = fmaxf({a}, 0.0f), b{n} = fmaxf({b}, 0.0f), c{n} = fmaxf({c}, 0.0f);\n"
            "float n{n} = sqrtf(a{n} * a{n} + b{n} * b{n} + c{n} * c{n}) + s{n};\n"
        )
        return (
            f"float ax = fabsf(px) - {bx}, ay = fabsf(py) - {by}, az = fabsf(pz) - {bz};\n"
            f"float qx = fabsf(ax + {e}) - {e};\n"
            f"float qy = fabsf(ay + {e}) - {e};\n"
            f"float qz = fabsf(az + {e}) - {e};\n"
            + seg.format(n=1, a="ax", b="qy", c="qz")
            + seg.format(n=2, a="qx", b="ay", c="qz")
            + seg.format(n=3, a="qx", b="qy", c="az")
            + "return fminf(n1, fminf(n2, n3));"
        )

    def bounds(self) -> Box:
        return Box.centered(np.zeros(3, _f32), self.dims)


class Torus(Shader3D):
    """Torus with axis in z (cpu_evaluators.go:59, primitives.go:216)."""

    PARAMS = ("r_lesser", "r_greater")
    CONT_PARAMS = ("r_lesser", "r_greater")

    def __init__(self, r_greater: float, r_lesser: float):
        self.r_greater = _f32(r_greater)
        self.r_lesser = _f32(r_lesser)

    def distance(self, p):
        qx = mx.hypot(p[..., 0], p[..., 1]) - mx.lit(self.r_greater)
        return mx.hypot(qx, p[..., 2]) - mx.lit(self.r_lesser)

    def emit_cuda(self, cg) -> str:
        return (
            f"float qx = sqrtf(px * px + py * py) - {cg.p(self, 'r_greater')};\n"
            f"return sqrtf(qx * qx + pz * pz) - {cg.p(self, 'r_lesser')};"
        )

    def bounds(self) -> Box:
        R = self.r_lesser + self.r_greater
        rl = self.r_lesser
        return Box(np.array([-R, -R, -rl], _f32), np.array([R, R, rl], _f32))


class Cylinder(Shader3D):
    """Cylinder with axis in z, optional edge rounding
    (cpu_evaluators.go:70, primitives.go:107)."""

    PARAMS = ("r", "h", "round")
    CONT_PARAMS = ("r", "h")  # round decides the emitter's branch

    def __init__(self, r: float, h: float, round: float):
        self.r = _f32(r)
        self.h = _f32(h)
        self.round = _f32(round)

    def _args(self):
        # reference primitives.go:147-149, float32 on the host
        return self.r, (self.h - 2 * self.round) / _f32(2), self.round

    def distance(self, p):
        r, h, rnd = (mx.lit(v) for v in self._args())
        d_axis = mx.hypot(p[..., 0], p[..., 1])
        dy = torch.abs(p[..., 2]) - h
        if rnd == 0:
            dx = d_axis - r
            return torch.clamp(torch.maximum(dx, dy), max=0.0) + mx.hypot(
                torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0)
            )
        dx = d_axis - r + rnd
        return (
            torch.clamp(torch.maximum(dx, dy), max=0.0)
            + mx.hypot(torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0))
            - rnd
        )

    def emit_cuda(self, cg) -> str:
        r, rnd = cg.p(self, "r"), cg.p(self, "round")
        h = cg.expr(self._args()[1], f"({cg.p(self, 'h')} - 2.0f * {rnd}) / 2.0f")
        head = (
            "float d_axis = sqrtf(px * px + py * py);\n"
            f"float dy = fabsf(pz) - {h};\n"
        )
        tail = (
            "float qx = fmaxf(dx, 0.0f);\n"
            "float qy = fmaxf(dy, 0.0f);\n"
        )
        if float(self.round) == 0:
            return (
                head
                + f"float dx = d_axis - {r};\n"
                + tail
                + "return fminf(0.0f, fmaxf(dx, dy)) + sqrtf(qx * qx + qy * qy);"
            )
        return (
            head
            + f"float dx = d_axis - {r} + {rnd};\n"
            + tail
            + "return fminf(fmaxf(dx, dy), 0.0f) + sqrtf(qx * qx + qy * qy)"
            + f" - {rnd};"
        )

    # d_axis = sqrtf(...) >= 0, dy = fabsf(pz) - h >= fl(0 - h) = -h.
    # Unrounded: dx = d_axis - r >= -r, so fminf(0, fmaxf(dx, dy)) >=
    # min(0, max(-r, -h)) = L, and L + sqrtf(...) >= L: the bound
    # -min(r, h) (h the half height), the radius for the showerhead's
    # holes. Rounded: dx = (d_axis - r) + rnd >= fl(fl(0 - r) + rnd), the
    # same L from it, and the result >= fl(L - rnd). No step makes a NaN
    # at a non-NaN point
    def lower_bound(self):
        r, h, rnd = self._args()
        if not finite(r, h, rnd):
            return NO_BOUND
        if float(self.round) == 0:
            return np.minimum(_f32(0.0), np.maximum(_f32(0.0) - r, _f32(0.0) - h))
        return np.minimum(np.maximum((_f32(0.0) - r) + rnd, _f32(0.0) - h), _f32(0.0)) - rnd

    def nan_free(self):
        return finite(*self._args())

    # With r, h and rnd finite, take dx = d_axis - r (rounded: (d_axis - r)
    # + rnd), the function's own dx. Where d_axis is no NaN (px, py no
    # NaN), dx is no NaN and so is the result, whatever pz: fmaxf drops a
    # NaN dy, and qy = fmaxf(dy, 0) is then 0. Where dx <= 0 the first
    # term fminf(fmaxf(dx, dy), 0) is >= dx and the root >= 0, so the sum
    # is >= dx. Where dx > 0 the first term is 0 and the sum is sqrtf(dx*dx
    # + qy*qy) >= sqrtf(fl(dx*dx)), which is dx exactly in binary float32
    # wherever dx*dx is normal (dx >= 2^-63) or overflows (inf); below
    # 2^-63 the square may underflow and the root fall under dx, never
    # under 0. So the sum is >= fl(dx - 2^-63) everywhere, and the rounded
    # result, the sum less rnd, is >= fl(fl(dx - 2^-63) - rnd) (rounding
    # is monotone): the point bound, NaN exactly where d_axis is
    def radial_bound(self):
        r, h, rnd = self._args()
        if not finite(r, h, rnd):
            return None
        if float(rnd) == 0:
            return (("-", r), ("-", _f32(2.0 ** -63)))
        return (("-", r), ("+", rnd), ("-", _f32(2.0 ** -63)), ("-", rnd))

    def bounds(self) -> Box:
        r, h = self.r, self.h
        return Box(np.array([-r, -r, -h / 2], _f32), np.array([r, r, h / 2], _f32))


class HexagonalPrism(Shader3D):
    """Hexagonal prism, z axis; side = face-to-face HALF-dimension semantics
    follow the reference exactly (cpu_evaluators.go:90, primitives.go:157).
    Height spans [-h, h]."""

    PARAMS = ("side", "h")
    CONT_PARAMS = ("side", "h")

    # reference constants; Python floats meet tensors as float32
    K1, K2, K3 = -mx.TRIBISECT, 0.5, 0.57735

    def __init__(self, side: float, h: float):
        self.side = _f32(side)
        self.h = _f32(h)

    def _clm(self):
        return _f32(self.K3) * self.side

    def distance(self, p):
        k1, k2 = self.K1, self.K2
        h1, h2, clm = mx.lit(self.side), mx.lit(self.h), mx.lit(self._clm())
        p = torch.abs(p)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        pm = torch.clamp(k1 * px + k2 * py, max=0.0)
        px = px - 2 * k1 * pm
        py = py - 2 * k2 * pm
        d1 = mx.hypot(px - torch.clamp(px, -clm, clm), py - h1) * mx.sign(py - h1)
        d2 = pz - h2
        return torch.clamp(torch.maximum(d1, d2), max=0.0) + mx.hypot(
            torch.clamp(d1, min=0.0), torch.clamp(d2, min=0.0)
        )

    def emit_cuda(self, cg) -> str:
        k1, k2 = cg.lit(self.K1), cg.lit(self.K2)
        k1x2, k2x2 = cg.lit(2 * self.K1), cg.lit(2 * self.K2)
        h1, h2 = cg.p(self, "side"), cg.p(self, "h")
        clm = cg.expr(self._clm(), f"{cg.lit(self.K3)} * {h1}")
        return (
            "float ax = fabsf(px), ay = fabsf(py), az = fabsf(pz);\n"
            f"float pm = fminf({k1} * ax + {k2} * ay, 0.0f);\n"
            f"ax = ax - {k1x2} * pm;\n"
            f"ay = ay - {k2x2} * pm;\n"
            f"float dx = ax - gsdf_clamp(ax, -{clm}, {clm});\n"
            f"float dy = ay - {h1};\n"
            "float d1 = sqrtf(dx * dx + dy * dy) * gsdf_sign(dy);\n"
            f"float d2 = az - {h2};\n"
            "float q1 = fmaxf(d1, 0.0f), q2 = fmaxf(d2, 0.0f);\n"
            "return fminf(fmaxf(d1, d2), 0.0f) + sqrtf(q1 * q1 + q2 * q2);"
        )

    def bounds(self) -> Box:
        l = float(self.side)
        lx = l / mx.TRIBISECT
        h = float(self.h)
        return Box(np.array([-lx, -l, -h], _f32), np.array([lx, l, h], _f32))


def make_bounds_box_frame(builder, bb: Box) -> Shader3D:
    """Debug helper enveloping a bounding box (reference primitives.go:12-21)."""
    size = bb.size()
    frame_thickness = _f32(size.max() / 256)
    size = size + 2 * frame_thickness
    bounding = builder.new_box_frame(size[0], size[1], size[2], frame_thickness)
    center = bb.center()
    return builder.translate(bounding, center[0], center[1], center[2])


class BuilderPrimitives3:
    """3D primitive constructors with reference validation rules."""

    def new_sphere(self, r: float) -> Shader3D:
        if not r > 0:
            self.shape_error("zero or negative sphere radius")
        return Sphere(r)

    def new_box(self, x: float, y: float, z: float, round: float = 0.0) -> Shader3D:
        if round < 0 or round > x / 2 or round > y / 2 or round > z / 2:
            self.shape_error("invalid box rounding value")
        if x <= 0 or y <= 0 or z <= 0:
            self.shape_error("zero or negative box dimension")
        return BoxShape((x, y, z), round)

    def new_cylinder(self, r: float, h: float, rounding: float = 0.0) -> Shader3D:
        if not (rounding >= 0 and rounding < r and rounding < h / 2):
            self.shape_error("invalid cylinder rounding")
        if not (r > 0 and h > 0):
            self.shape_error("bad cylinder dimension")
        return Cylinder(r, h, rounding)

    def new_hexagonal_prism(self, face2face: float, h: float) -> Shader3D:
        if face2face <= 0 or h <= 0:
            self.shape_error("invalid hexagonal prism parameter")
        return HexagonalPrism(face2face, h)

    def new_triangular_prism(self, tri_height: float, extrude_length: float) -> Shader3D:
        if not (extrude_length > 0 and not math.isinf(extrude_length)):
            self.shape_error("bad triangular prism extrude length")
        tri = self.new_equilateral_triangle(tri_height)
        return self.extrude(tri, extrude_length)

    def new_torus(self, greater_radius: float, lesser_radius: float) -> Shader3D:
        if greater_radius < 2 * lesser_radius:
            self.shape_error("too large torus lesser radius")
        if greater_radius <= 0 or lesser_radius <= 0:
            self.shape_error("invalid torus parameter")
        return Torus(greater_radius, lesser_radius)

    def new_box_frame(self, dim_x: float, dim_y: float, dim_z: float, e: float) -> Shader3D:
        e = e / 2
        if dim_x <= 0 or dim_y <= 0 or dim_z <= 0 or e <= 0:
            self.shape_error("negative or zero BoxFrame dimension")
        if 2 * e > min(dim_x, dim_y, dim_z):
            self.shape_error("BoxFrame edge thickness too large")
        return BoxFrame((dim_x, dim_y, dim_z), e)

    def new_bounds_box_frame(self, bb: Box) -> Shader3D:
        return make_bounds_box_frame(self, bb)
