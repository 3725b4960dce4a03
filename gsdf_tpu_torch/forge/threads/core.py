"""Screw machinery core (gsdf_tpu/forge/threads/core.py): Threader,
Parameters, the screw node.

The screw node's domain transform (reference threads.go:141-181):
    y  = hypot(px,py) + pz*tan(taper)
    th = atan2(py,px)
    z' = pz + lead*th/(2*pi)
    x  = sawtooth(z', pitch)
    d  = max(profile(x,y), |pz| - L/2)
atan2 is a library function on every device (mx.atan2, atan2f): its sign
on the +-0 seam (threads.go:155) must match the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import mathx as mx
from ...core.node import NO_BOUND, Shader2D, Shader3D, finite
from ...geometry.boxes import Box

_f32 = np.float32

COSD30 = math.sqrt(3) / 2
SIND30 = 0.5


@dataclasses.dataclass
class Parameters:
    """Thread parameters (reference threads.go:33-50). Derived quantities
    are float32 steps, as in the reference's Go float32 arithmetic."""

    name: str = "basic"
    radius: float = 0.0  # nominal major radius of screw
    pitch: float = 0.0  # thread-to-thread distance
    starts: int = 1  # number of threads
    taper: float = 0.0  # thread taper (radians)
    hex_f2f: float = 0.0  # hex head flat-to-flat distance

    def hex_radius(self) -> float:
        return float(_f32(self.hex_f2f) / (_f32(2.0) * _f32(COSD30)))

    def hex_height(self) -> float:
        return float(_f32(2.0) * _f32(self.hex_radius()) * (_f32(5.0) / _f32(12.0)))


class Threader:
    """Thread profile provider (reference threads.go:28-31)."""

    def thread(self, bld) -> Shader2D:  # pragma: no cover - interface
        raise NotImplementedError

    def thread_params(self) -> Parameters:  # pragma: no cover - interface
        raise NotImplementedError


class ScrewNode(Shader3D):
    """3D helical sweep of a 2D thread profile (threads.go:62-196)."""

    PARAMS = ("pitch", "lead", "length_div2", "taper")
    CONT_PARAMS = ("pitch", "lead", "length_div2")  # the taper's tangent is the host's
    CHILDREN = ("thread",)

    def __init__(self, thread: Shader2D, pitch, lead, length_div2, taper):
        self.thread = thread
        self.pitch = _f32(pitch)
        self.lead = _f32(lead)
        self.length_div2 = _f32(length_div2)
        self.taper = _f32(taper)

    def _consts(self):
        """Host float32 constants, computed as the JAX package does."""
        return dict(
            # single-precision tan like the reference's math32.Tan
            tan_taper=np.tan(self.taper, dtype=_f32),
            two_pi=_f32(2 * math.pi),
            half_pitch=self.pitch / _f32(2),
            half_pitch_mul=_f32(0.5) * self.pitch,
        )

    def distance(self, p):
        c = self._consts()
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        y = mx.sqrt(px * px + py * py) + pz * mx.lit(c["tan_taper"])
        theta = mx.atan2(py, px)
        z = pz + mx.div(mx.lit(self.lead) * theta, c["two_pi"])
        # sawtooth (threads.go:198-202)
        zz = z + mx.lit(c["half_pitch"])
        t = mx.div(zz, self.pitch)
        x = mx.lit(self.pitch) * (t - torch.floor(t)) - mx.lit(c["half_pitch_mul"])
        d2 = self.thread.distance(torch.stack([x, y], dim=-1))
        d3 = torch.abs(pz) - mx.lit(self.length_div2)
        return torch.maximum(d2, d3)

    def emit_cuda(self, cg) -> str:
        v = self._consts()
        pitch = cg.p(self, "pitch")
        c = {
            "tan_taper": cg.lit(v["tan_taper"]),
            "two_pi": cg.lit(v["two_pi"]),
            "half_pitch": cg.expr(v["half_pitch"], f"{pitch} / 2.0f"),
            "half_pitch_mul": cg.expr(v["half_pitch_mul"], f"0.5f * {pitch}"),
        }
        return (
            f"float y = sqrtf(px * px + py * py) + pz * {c['tan_taper']};\n"
            "float theta = atan2f(py, px);\n"
            f"float z = pz + {cg.p(self, 'lead')} * theta / {c['two_pi']};\n"
            f"float zz = z + {c['half_pitch']};\n"
            f"float t = zz / {pitch};\n"
            f"float x = {pitch} * (t - floorf(t)) - {c['half_pitch_mul']};\n"
            f"return fmaxf({cg.call(self.thread, 'x', 'y')}, "
            f"fabsf(pz) - {cg.p(self, 'length_div2')});"
        )

    # fmaxf(profile, fabsf(pz) - half) >= fabsf(pz) - half >= fl(0 - half)
    # = -half: the second operand is no NaN at a non-NaN point, so fmaxf
    # returns at least it whatever the profile gives. The profile's own
    # bound does not carry over: its point (x, y) is NaN where z is huge
    # (the sawtooth's t - floorf(t) at t = inf, pz * 0 at pz = inf)
    def lower_bound(self):
        return -self.length_div2 if finite(self.length_div2) else NO_BOUND

    def nan_free(self):
        return finite(self.length_div2)

    def bounds(self) -> Box:
        # reference threads.go:184-196, float32 steps like the Go original
        r = _f32(self.thread.bounds().max[1])
        r = _f32(r + self.length_div2 * np.tan(self.taper, dtype=_f32))
        L = self.length_div2
        return Box(np.array([-r, -r, -L], _f32), np.array([r, r, L], _f32))


def screw(bld, length: float, thread: Threader) -> Shader3D:
    """Construct a screw of given length from a Threader
    (reference threads.go:76-96)."""
    if thread is None:
        raise ValueError("nil threader")
    if length <= 0:
        raise ValueError("need greater than zero length")
    tsdf = thread.thread(bld)
    params = thread.thread_params()
    return ScrewNode(
        tsdf,
        pitch=params.pitch,
        lead=-params.pitch * params.starts,
        length_div2=length / 2,
        taper=params.taper,
    )


@dataclasses.dataclass
class Basic(Threader):
    """Building block for most threads (reference threads.go:205-222)."""

    d: float  # thread nominal diameter
    p: float  # thread pitch

    def thread_params(self) -> Parameters:
        radius = self.d / 2
        return Parameters(
            name="basic",
            radius=radius,
            pitch=self.p,
            starts=1,
            taper=0.0,
            hex_f2f=metric_f2f(radius),
        )


# Metric hex flat-to-flat dimensions [mm] (reference threads.go:225)
_METRIC_F2F_TABLE = [
    1.75, 2, 3.2, 4, 5, 6, 7, 8, 10, 13, 17, 19, 24, 30, 36, 46, 55, 65, 75, 85, 95,
]


def metric_f2f(radius: float) -> float:
    """Reasonable hex flat-to-flat for a metric screw of nominal radius
    (reference threads.go:229-251)."""
    if radius < 1.2 / 2:
        est = 3.2 * radius
    elif radius < 3.8 / 2:
        est = 4.5 * radius
    elif radius < 4.2 / 2:
        est = 4.0 * radius
    else:
        est = 3.5 * radius
    if abs(radius - 56.0 / 2) < 1:
        est = 86
    for v in reversed(_METRIC_F2F_TABLE):
        if est - 1e-2 > v:
            return v
    return _METRIC_F2F_TABLE[0]
