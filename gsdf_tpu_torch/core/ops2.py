"""2D operations and the 2D->3D bridges Extrusion and Revolution
(gsdf_tpu/core/ops2.py).

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:506-549,821-1255; operations2d.go). A 2D node's
generated C function takes (px, py); Extrusion and Revolution call it
from their 3D functions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.boxes import Box, rotation_mat2
from . import mathx as mx
from .node import NO_BOUND, Shader2D, Shader3D, finite
from .ops3 import (
    _array_distance,
    _Binary,
    _Circular,
    _Difference,
    _elongate_distance,
    _emit_array,
    _emit_elongate,
    _Intersection,
)

_f32 = np.float32


class OpUnion2D(Shader2D):
    """(cpu_evaluators.go:821, operations2d.go:15)."""

    def __init__(self, joined):
        if len(joined) < 2:
            raise ValueError("OpUnion2D must have at least 2 elements")
        self.joined = tuple(joined)

    def children(self):
        return self.joined

    def distance(self, p):
        d = self.joined[0].distance(p)
        for s in self.joined[1:]:
            d = torch.minimum(d, s.distance(p))
        return d

    def emit_cuda(self, cg) -> str:
        lines = [f"float d = {cg.call(self.joined[0], 'px', 'py')};"]
        lines += [f"d = fminf(d, {cg.call(s, 'px', 'py')});" for s in self.joined[1:]]
        lines.append("return d;")
        return "\n".join(lines)

    # fminf(x, NaN) is x: the result is NaN or a child's value, so >= the
    # least of the children's bounds, and no NaN where one child is
    # NaN-free
    def lower_bound(self):
        return min(s.lower_bound() for s in self.joined)

    def nan_free(self):
        return any(s.nan_free() for s in self.joined)

    def bounds(self) -> Box:
        bb = self.joined[0].bounds()
        for s in self.joined[1:]:
            bb = bb.union(s.bounds())
        return bb


class Difference2D(_Difference, Shader2D):
    pass


class Intersection2D(_Intersection, Shader2D):
    pass


class Xor2D(_Binary, Shader2D):
    _C = "fmaxf(fminf(a, b), -fmaxf(a, b))"

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        return torch.maximum(torch.minimum(a, b), -torch.maximum(a, b))

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class Extrusion(Shader3D):
    """2D -> 3D extrusion along z (cpu_evaluators.go:506, operations2d.go:104)."""

    PARAMS = ("h",)
    CONT_PARAMS = ("h",)
    CHILDREN = ("s",)

    def __init__(self, s: Shader2D, h):
        self.s = s
        self.h = _f32(h)

    def distance(self, p):
        d = self.s.distance(p[..., :2])
        wy = torch.abs(p[..., 2]) - mx.lit(self.h / _f32(2))
        return torch.clamp(torch.maximum(d, wy), max=0.0) + mx.hypot(
            torch.clamp(d, min=0.0), torch.clamp(wy, min=0.0)
        )

    def emit_cuda(self, cg) -> str:
        return (
            f"float d = {cg.call(self.s, 'px', 'py')};\n"
            f"float wy = fabsf(pz) - {cg.expr(self.h / _f32(2), cg.p(self, 'h') + ' / 2.0f')};\n"
            "float qd = fmaxf(d, 0.0f), qw = fmaxf(wy, 0.0f);\n"
            "return fminf(0.0f, fmaxf(d, wy)) + sqrtf(qd * qd + qw * qw);"
        )

    # With h finite and pz no NaN, wy is no NaN and >= -h/2, whatever d
    # (fmaxf drops a NaN d; qd and qw are then non-negative and no NaN), so
    # the first term lies in [-h/2, 0] and the result is no NaN. Where
    # wy <= 0 the first term is >= fminf(0, wy) = wy and the root >= 0, so
    # the sum is >= wy. Where wy > 0 the first term is 0 and the result
    # sqrtf(qd*qd + wy*wy) >= sqrtf(fl(wy*wy)), which is wy exactly in
    # binary float32 wherever wy*wy is normal (wy >= 2^-63) or overflows
    # (inf); only below 2^-63 does the square underflow, and the root may
    # fall under wy there, but never under 0. So the result is >=
    # fl(wy - 2^-63) everywhere: the point bound, NaN exactly where pz is
    def emit_point_bound(self, cg):
        if not finite(self.h / _f32(2)):
            return None
        return f"return fabsf(pz) - {cg.lit(self.h / _f32(2))} - {cg.lit(2.0 ** -63)};"

    def nan_free(self):
        return finite(self.h / _f32(2))

    def bounds(self) -> Box:
        b2 = self.s.bounds()
        hd2 = self.h / 2
        return Box(
            np.array([b2.min[0], b2.min[1], -hd2], _f32),
            np.array([b2.max[0], b2.max[1], hd2], _f32),
        )


class Revolution(Shader3D):
    """Revolve 2D shape about y axis (cpu_evaluators.go:533, operations2d.go:153)."""

    PARAMS = ("off",)
    CONT_PARAMS = ("off",)
    CHILDREN = ("s",)

    def __init__(self, s: Shader2D, off):
        self.s = s
        self.off = _f32(off)

    def distance(self, p):
        qx = mx.hypot(p[..., 0], p[..., 2]) - mx.lit(self.off)
        return self.s.distance(torch.stack([qx, p[..., 1]], dim=-1))

    def emit_cuda(self, cg) -> str:
        return (
            f"float qx = sqrtf(px * px + pz * pz) - {cg.p(self, 'off')};\n"
            f"return {cg.call(self.s, 'qx', 'py')};"
        )

    def bounds(self) -> Box:
        b2 = self.s.bounds()
        radius = max(0.0, float(b2.max[0]) - float(self.off))
        return Box(
            np.array([-radius, b2.min[1], -radius], _f32),
            np.array([radius, b2.max[1], radius], _f32),
        )


class Array2D(Shader2D):
    """Limited 2D grid repetition (cpu_evaluators.go:914, operations2d.go:332)."""

    PARAMS = ("d", "nx", "ny")
    CONT_PARAMS = ("d",)
    CHILDREN = ("s",)

    def __init__(self, s, d, nx, ny):
        self.s = s
        self.d = np.asarray(d, dtype=_f32)
        self.nx, self.ny = int(nx), int(ny)

    def distance(self, p):
        return _array_distance(self.s, p, self.d, (self.nx, self.ny))

    def emit_cuda(self, cg) -> str:
        return _emit_array(cg, self, (self.nx, self.ny))

    def bounds(self) -> Box:
        bb = self.s.bounds()
        size = np.array([self.nx, self.ny], _f32) * self.d
        return Box(bb.min, bb.max + size)


class Offset2D(Shader2D):
    PARAMS = ("f",)
    CONT_PARAMS = ("f",)
    CHILDREN = ("s",)

    def __init__(self, s, f):
        self.s = s
        self.f = _f32(f)

    def distance(self, p):
        return self.s.distance(p) + mx.lit(self.f)

    def emit_cuda(self, cg) -> str:
        return f"return {cg.call(self.s, 'px', 'py')} + {cg.p(self, 'f')};"

    def bounds(self) -> Box:
        # reference operations2d.go:421-430 (incl. its positive-offset quirk)
        bb = self.s.bounds()
        if self.f > 0:
            return bb
        return Box(bb.min + self.f, bb.max - self.f)


class Translate2D(Shader2D):
    PARAMS = ("p_",)
    CONT_PARAMS = ("p_",)
    CHILDREN = ("s",)

    def __init__(self, s, v):
        self.s = s
        self.p_ = np.asarray(v, dtype=_f32)

    def distance(self, p):
        return self.s.distance(p - mx.const(self.p_, p))

    def emit_cuda(self, cg) -> str:
        x, y = cg.p(self, "p_")
        return f"return {cg.call(self.s, f'px - {x}', f'py - {y}')};"

    # as Translate's (ops3)
    def lower_bound(self):
        return self.s.lower_bound() if finite(self.p_) else NO_BOUND

    def nan_free(self):
        return finite(self.p_) and self.s.nan_free()

    def bounds(self) -> Box:
        return self.s.bounds().add(self.p_)


class Rotation2D(Shader2D):
    """(cpu_evaluators.go:1186, operations2d.go:495)."""

    PARAMS = ("t",)
    CONT_PARAMS = ("t", "t_inv")  # t_inv: see ops3.Transform
    CHILDREN = ("s",)

    def __init__(self, s, theta):
        self.s = s
        self.t = rotation_mat2(theta)
        self._rebind_derived()

    def _rebind_derived(self):
        """Recompute t_inv from t (see ops3.Transform._rebind_derived)."""
        self.t_inv = np.linalg.inv(np.asarray(self.t, np.float64)).astype(_f32)

    def distance(self, p):
        # expanded mul-adds, never a matmul (see ops3's module note)
        r = [[mx.lit(v) for v in row] for row in self.t_inv]
        x, y = p[..., 0], p[..., 1]
        return self.s.distance(
            torch.stack([x * r[0][0] + y * r[0][1], x * r[1][0] + y * r[1][1]], dim=-1)
        )

    def emit_cuda(self, cg) -> str:
        r00, r01, r10, r11 = cg.p(self, "t_inv")
        return (
            f"float qx = px * {r00} + py * {r01};\n"
            f"float qy = px * {r10} + py * {r11};\n"
            f"return {cg.call(self.s, 'qx', 'qy')};"
        )

    def bounds(self) -> Box:
        bb = self.s.bounds()
        verts = bb.vertices() @ self.t.T
        return Box(verts.min(axis=0).astype(_f32), verts.max(axis=0).astype(_f32))


class Symmetry2D(Shader2D):
    PARAMS = ("mx_", "my_")
    CHILDREN = ("s",)

    def __init__(self, s, mirror_x, mirror_y):
        self.s = s
        self.mx_ = bool(mirror_x)
        self.my_ = bool(mirror_y)

    def distance(self, p):
        cols = [torch.abs(p[..., i]) if m else p[..., i] for i, m in enumerate((self.mx_, self.my_))]
        return self.s.distance(torch.stack(cols, dim=-1))

    def emit_cuda(self, cg) -> str:
        args = [f"fabsf({a})" if m else a for a, m in zip(("px", "py"), (self.mx_, self.my_))]
        return f"return {cg.call(self.s, *args)};"

    def bounds(self) -> Box:
        bb = self.s.bounds()
        lo = bb.min.copy()
        hi = bb.max.copy()
        for i, m in enumerate((self.mx_, self.my_)):
            if m:
                lo[i] = min(lo[i], -hi[i])
        return Box(lo, hi)


class Annulus2D(Shader2D):
    """2D shell (cpu_evaluators.go:1026, operations2d.go:606)."""

    PARAMS = ("r",)
    CONT_PARAMS = ("r",)
    CHILDREN = ("s",)

    def __init__(self, s, r):
        self.s = s
        self.r = _f32(r)

    def distance(self, p):
        return torch.abs(self.s.distance(p)) - mx.lit(self.r)

    def emit_cuda(self, cg) -> str:
        return f"return fabsf({cg.call(self.s, 'px', 'py')}) - {cg.p(self, 'r')};"

    def bounds(self) -> Box:
        return self.s.bounds().pad(self.r)


class CircularArray2D(_Circular, Shader2D):
    """(cpu_evaluators.go:1094, operations2d.go:655)."""

    def distance(self, p):
        d0, d1 = (
            self.s.distance(torch.stack([x, y], dim=-1))
            for x, y in self._instances(p[..., 0], p[..., 1])
        )
        return torch.minimum(d0, d1)

    def emit_cuda(self, cg) -> str:
        return self._emit(cg, ())

    def bounds(self) -> Box:
        return self._rotated_bounds(self.s.bounds())


class Scale2D(Shader2D):
    PARAMS = ("factor",)
    CONT_PARAMS = ("factor",)
    CHILDREN = ("s",)

    def __init__(self, s, factor):
        self.s = s
        self.factor = _f32(factor)

    def _inv(self):
        return _f32(1.0) / self.factor

    def distance(self, p):
        return self.s.distance(p * mx.lit(self._inv())) * mx.lit(self.factor)

    def emit_cuda(self, cg) -> str:
        factor = cg.p(self, "factor")
        inv = cg.expr(self._inv(), f"1.0f / {factor}")
        return f"return {cg.call(self.s, f'px * {inv}', f'py * {inv}')} * {factor};"

    def bounds(self) -> Box:
        return self.s.bounds().scale((self.factor,) * 2)


class TranslateMulti2D(Shader2D):
    """N displaced instances, min-reduced (cpu_evaluators.go:1162,
    operations2d.go:756); the generated C loops over a displacement
    table."""

    PARAMS = ("displacements",)
    CHILDREN = ("s",)

    def __init__(self, s, displacements):
        self.s = s
        self.displacements = np.asarray(displacements, dtype=_f32).reshape(-1, 2)

    def distance(self, p):
        d = torch.full(p.shape[:-1], float(np.finfo(_f32).max), dtype=torch.float32,
                       device=p.device)
        disp = mx.const(self.displacements, p)
        for i in range(len(self.displacements)):
            d = torch.minimum(d, self.s.distance(p - disp[i]))
        return d

    def emit_cuda(self, cg) -> str:
        arr = cg.array(self, self.displacements)
        return (
            f"float d = {cg.lit(np.finfo(_f32).max)};\n"
            f"for (int i = 0; i < {len(self.displacements)}; ++i) {{\n"
            f"    const float* o = {arr} + 2 * i;\n"
            f"    d = fminf(d, {cg.call(self.s, 'px - o[0]', 'py - o[1]')});\n"
            "}\n"
            "return d;"
        )

    def bounds(self) -> Box:
        bb = Box.empty(2)
        elem = self.s.bounds()
        for disp in self.displacements:
            bb = bb.union(elem.add(disp))
        return bb


class Elongate2D(Shader2D):
    PARAMS = ("h",)
    CONT_PARAMS = ("h",)
    CHILDREN = ("s",)

    def __init__(self, s, h):
        self.s = s
        self.h = np.asarray(h, dtype=_f32)

    def distance(self, p):
        return _elongate_distance(self.s, p, self.h)

    def emit_cuda(self, cg) -> str:
        return _emit_elongate(cg, self)

    def bounds(self) -> Box:
        bb = self.s.bounds()
        hi = np.maximum(bb.max, 0).astype(_f32) + self.h * _f32(0.5)
        return Box(-hi, hi)


class BuilderOps2:
    """2D operation constructors with reference validation rules."""

    def union2d(self, *shaders) -> Shader2D:
        if len(shaders) < 2:
            raise ValueError("need at least 2 arguments to union2d")
        joined = []
        for i, s in enumerate(shaders):
            if s is None:
                raise ValueError(f"nil {i} argument to union2d")
            if isinstance(s, OpUnion2D):
                joined.extend(s.joined)
            else:
                joined.append(s)
        return OpUnion2D(joined)

    def extrude(self, s, h) -> Shader3D:
        if s is None:
            self.nilsdf("extrude")
        if h < 0:
            self.shape_error("bad extrusion length")
        return Extrusion(s, h)

    def revolve(self, s, axis_offset=0.0) -> Shader3D:
        if s is None:
            self.shape_error("nil argument to revolve")
        if axis_offset < 0:
            self.shape_error("negative axis offset")
        return Revolution(s, axis_offset)

    def difference2d(self, a, b) -> Shader2D:
        if a is None or b is None:
            self.nilsdf("difference2d")
        return Difference2D(a, b)

    def intersection2d(self, a, b) -> Shader2D:
        if a is None or b is None:
            self.nilsdf("intersection2d")
        return Intersection2D(a, b)

    def xor2d(self, s1, s2) -> Shader2D:
        if s1 is None or s2 is None:
            self.nilsdf("xor2d")
        return Xor2D(s1, s2)

    def array2d(self, s, spacing_x, spacing_y, nx, ny) -> Shader2D:
        if nx <= 0 or ny <= 0:
            self.shape_error("invalid array repeat param")
        ok = (
            spacing_x > 0
            and spacing_y > 0
            and not math.isinf(spacing_x)
            and not math.isinf(spacing_y)
        )
        if not ok:
            self.shape_error("bad array spacing")
        return Array2D(s, (spacing_x, spacing_y), nx, ny)

    def offset2d(self, s, sdf_add) -> Shader2D:
        return Offset2D(s, sdf_add)

    def translate2d(self, s, dir_x, dir_y) -> Shader2D:
        return Translate2D(s, (dir_x, dir_y))

    def rotate2d(self, s, theta) -> Shader2D:
        m = rotation_mat2(theta)
        if abs(float(np.linalg.det(m.astype(np.float64)))) < mx.EPSTOL:
            self.shape_error("badly conditioned rotation")
        return Rotation2D(s, theta)

    def symmetry2d(self, s, mirror_x=False, mirror_y=False) -> Shader2D:
        if not (mirror_x or mirror_y):
            self.shape_error("ineffective symmetry")
        return Symmetry2D(s, mirror_x, mirror_y)

    def annulus(self, s, sub) -> Shader2D:
        if s is None:
            self.nilsdf("annulus")
        if sub <= 0:
            self.shape_error("invalid annular parameter")
        return Annulus2D(s, sub)

    def circular_array2d(self, s, num_instances, circle_div) -> Shader2D:
        if s is None:
            self.nilsdf("circular_array2d")
        if circle_div <= 1 or num_instances <= 0:
            self.shape_error("invalid circarray repeat param")
        if num_instances > circle_div:
            self.shape_error(
                "bad circular array instances, must be less than or equal to circle_div"
            )
        return CircularArray2D(s, num_instances, circle_div)

    def scale2d(self, s, factor) -> Shader2D:
        return Scale2D(s, factor)

    def translate_multi2d(self, s, displacements) -> Shader2D:
        if s is None:
            self.nilsdf("translate_multi2d")
        return TranslateMulti2D(s, displacements)

    def elongate2d(self, s, dir_x, dir_y) -> Shader2D:
        return Elongate2D(s, (dir_x, dir_y))
