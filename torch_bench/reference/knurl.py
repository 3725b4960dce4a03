"""Plain PyTorch nodes that upstream's knurled cylinder needs beside
`sdf.py`'s and `text.py`'s: a box, a twist about z, circular domain
repetition about z and a smooth difference. It imports nothing of the
program under test.

The expressions are those of the published CAD kernel (soypat/gsdf:
primitives.go and cpu_evaluators.go for the box, operations.go:835 and
cpu_evaluators.go for the twist, operations.go:764 and
cpu_evaluators.go:1042 for the circular array, operations.go:611 and
cpu_evaluators.go:238 for the smooth difference), in float32. Departures
from it:

- on the CPU, cos and sin of float32 points run in float64 and are rounded
  once, as `sdf.sqrt` does (torch's float32 CPU sin and cos are not
  correctly rounded); on the card they are the CUDA math library's sinf and
  cosf. atan2 is torch's float32 function on every device;
- the circular array evaluates its child at the two instances nearest the
  point's angle and takes the smaller distance, as upstream does: an
  instance farther round the circle is never looked at, so the array is
  exact only where no third instance comes nearer;
- the circular array's and the twist's boxes are computed as upstream
  computes them (the child's box corners rotated through every instance;
  the largest corner radius of the child's box), in float32.

`distance` keeps the dtype of `p` (the control evaluates bfloat16 points).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import sdf

_f32 = np.float32


def _rounded(fn, x):
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return fn(x.double()).float()
    return fn(x)


def cos(x):
    return _rounded(torch.cos, x)


def sin(x):
    return _rounded(torch.sin, x)


class Box:
    """A box of sides `dims` centred at the origin, its edges rounded by
    `round` (cpu_evaluators.go's box): q = (|p| - dims / 2) + round, the
    length of q's positive part plus min(max(q), 0), less round."""

    def __init__(self, x, y, z, round=0.0):
        self.dims, self.round = np.array([x, y, z], _f32), _f32(round)

    def distance(self, p):
        rnd = sdf.lit(self.round)
        q = torch.abs(p) - sdf.const(self.dims * _f32(0.5), p) + rnd
        o = torch.clamp(q, min=0.0)
        outside = sdf.sqrt((o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1]) + o[..., 2] * o[..., 2])
        inside = torch.clamp(torch.maximum(q[..., 0], torch.maximum(q[..., 1], q[..., 2])),
                             max=0.0)
        return outside + inside - rnd

    def bounds(self):
        half = self.dims / _f32(2)
        return sdf._box(-half, half)


class Twist:
    """The child with xy turned by k z at height z (operations.go:835):
    (cos(kz) x - sin(kz) y, sin(kz) x + cos(kz) y, z)."""

    #: a domain warp, not 1-Lipschitz (raymarch.relaxation)
    WARPS = True

    def __init__(self, s, k):
        self.s, self.k = s, _f32(k)

    def distance(self, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        a = sdf.lit(self.k) * z
        c, s = cos(a), sin(a)
        return self.s.distance(torch.stack([c * x - s * y, s * x + c * y, z], dim=-1))

    def bounds(self):
        """A square about z of the largest radius of the child's box
        corners, over the child's height."""
        lo, hi = self.s.bounds()
        r = _f32(max(np.hypot(x, y) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])))
        return sdf._box([-r, -r, lo[2]], [r, r, hi[2]])


class CircularArray:
    """`n` copies of the child about z, one each 2 pi / `div` turn
    (operations.go:764, cpu_evaluators.go:1042). The point's sector is
    floor(atan2(y, x) / angle), taken into [0, div); the child is evaluated
    at the point turned back into that sector's instance and the next one
    (the last instance's neighbour is instance 0), and the smaller
    distance wins. Turning back by a is the transposed 2D rotation:
    (cos(a) x + sin(a) y, -sin(a) x + cos(a) y)."""

    def __init__(self, s, n, div):
        self.s, self.n, self.div = s, int(n), int(div)

    def _angle(self):
        return _f32(2 * math.pi / self.div)

    def distance(self, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        angle = self._angle()
        last = sdf.lit(self.n - 1)
        sector = torch.floor(sdf.div(torch.atan2(y, x), angle))
        sector = torch.where(sector < 0, sector + sdf.lit(self.div), sector)
        wraps = sector >= last
        d = None
        for i in (torch.where(wraps, last, sector), torch.where(wraps, 0.0, sector + 1.0)):
            a = sdf.lit(angle) * i
            c, s = cos(a), sin(a)
            di = self.s.distance(torch.stack([c * x + s * y, -s * x + c * y, z], dim=-1))
            d = di if d is None else torch.minimum(d, di)
        return d

    def bounds(self):
        """The child's xy box with its corners rotated through each
        instance, by the float32 rotation by one step applied again and
        again; z as the child's."""
        lo, hi = self.s.bounds()
        theta = self._angle()
        c, s = np.cos(theta), np.sin(theta)
        step = np.array([[c, -s], [s, c]], _f32)
        corners = np.array([[x, y] for y in (lo[1], hi[1]) for x in (lo[0], hi[0])], _f32)
        xy_lo, xy_hi = lo[:2].copy(), hi[:2].copy()
        for _ in range(self.n - 1):
            corners = corners @ step.T
            xy_lo = np.minimum(xy_lo, corners.min(axis=0))
            xy_hi = np.maximum(xy_hi, corners.max(axis=0))
        return sdf._box([*xy_lo, lo[2]], [*xy_hi, hi[2]])


class SmoothDifference:
    """a less b, blended over k (cpu_evaluators.go:238): h = clamp(0.5 -
    0.5 (b + a) / k, 0, 1), then mix(a, -b, h) + k h (1 - h)."""

    def __init__(self, k, a, b):
        self.k, self.a, self.b = _f32(k), a, b

    def distance(self, p):
        a, b = self.a.distance(p), self.b.distance(p)
        h = torch.clamp(0.5 - sdf.div(0.5 * (b + a), self.k), 0.0, 1.0)
        return (a * (1 - h) + (-b) * h) + sdf.lit(self.k) * h * (1 - h)

    def bounds(self):
        return self.a.bounds()
