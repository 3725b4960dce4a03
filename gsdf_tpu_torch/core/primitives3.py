"""3D primitives of the ported slice (gsdf_tpu/core/primitives3.py).

Each node's `distance` maps torch (..., 3) -> (...,) float32 and its
`emit_cuda` writes the same arithmetic, in the same association, as C.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.boxes import Box
from . import mathx as mx
from .node import Shader3D

_f32 = np.float32


class Cylinder(Shader3D):
    """Cylinder with axis in z, optional edge rounding
    (cpu_evaluators.go:70, primitives.go:107)."""

    PARAMS = ("r", "h", "round")

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
        r, h, rnd = (cg.lit(v) for v in self._args())
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

    def bounds(self) -> Box:
        r, h = self.r, self.h
        return Box(np.array([-r, -r, -h / 2], _f32), np.array([r, r, h / 2], _f32))


class BuilderPrimitives3:
    """3D primitive constructors with reference validation rules."""

    def new_cylinder(self, r: float, h: float, rounding: float = 0.0) -> Shader3D:
        if not (rounding >= 0 and rounding < r and rounding < h / 2):
            self.shape_error("invalid cylinder rounding")
        if not (r > 0 and h > 0):
            self.shape_error("bad cylinder dimension")
        return Cylinder(r, h, rounding)
