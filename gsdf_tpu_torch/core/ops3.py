"""3D CSG operations of the ported slice (gsdf_tpu/core/ops3.py).

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:124-549; operations.go:14-891), in the JAX package's
association. OpUnion keeps the JAX package's grouping of identical
translated subtrees (ops3.py:77-124): the subtree is evaluated, and
emitted, once and looped over a table of offsets. float32 min is exact,
so the grouping changes no value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.boxes import Box
from . import mathx as mx
from .node import Shader3D

_f32 = np.float32


class OpUnion(Shader3D):
    """n-ary exact union (cpu_evaluators.go:124, operations.go:27)."""

    #: minimum identical-translate group size for the offset loop
    SCAN_THRESHOLD = 4

    def __init__(self, joined):
        if len(joined) < 2:
            raise ValueError("OpUnion must have at least 2 elements")
        self.joined = tuple(joined)

    def children(self):
        return self.joined

    def _groups(self):
        """([(child, offsets (G,3) f32)], [nodes evaluated one by one])."""
        groups: dict = {}
        ordered = []
        for s in self.joined:
            if isinstance(s, Translate):
                groups.setdefault(s.s.tree_hash(), []).append(s)
            else:
                ordered.append(s)
        looped = []
        for nodes in groups.values():
            if len(nodes) >= self.SCAN_THRESHOLD:
                offsets = np.stack([n.p_ for n in nodes]).astype(_f32)
                looped.append((nodes[0].s, offsets))
            else:
                ordered.extend(nodes)
        return looped, ordered

    def distance(self, p):
        looped, ordered = self._groups()
        d = None
        for child, offsets in looped:
            off = mx.const(offsets, p)
            dg = torch.full(p.shape[:-1], mx.LARGENUM, dtype=torch.float32, device=p.device)
            for g in range(len(offsets)):
                dg = torch.minimum(dg, child.distance(p - off[g]))
            d = dg if d is None else torch.minimum(d, dg)
        for s in ordered:
            ds = s.distance(p)
            d = ds if d is None else torch.minimum(d, ds)
        return d

    def emit_cuda(self, cg) -> str:
        looped, ordered = self._groups()
        lines = []
        terms = []
        for gi, (child, offsets) in enumerate(looped):
            arr = cg.array(self, offsets)
            call = cg.call(child, "px - o[0]", "py - o[1]", "pz - o[2]")
            lines.append(
                f"float dg{gi} = {cg.lit(mx.LARGENUM)};\n"
                f"for (int g = 0; g < {len(offsets)}; ++g) {{\n"
                f"    const float* o = {arr} + 3 * g;\n"
                f"    dg{gi} = fminf(dg{gi}, {call});\n"
                "}"
            )
            terms.append(f"dg{gi}")
        terms += [cg.call(s, "px", "py", "pz") for s in ordered]
        lines.append(f"float d = {terms[0]};")
        lines += [f"d = fminf(d, {t});" for t in terms[1:]]
        lines.append("return d;")
        return "\n".join(lines)

    def bounds(self) -> Box:
        bb = self.joined[0].bounds()
        for s in self.joined[1:]:
            bb = bb.union(s.bounds())
        return bb


class Difference(Shader3D):
    """s1 - s2 (cpu_evaluators.go:168, operations.go:117)."""

    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return torch.maximum(self.s1.distance(p), -self.s2.distance(p))

    def emit_cuda(self, cg) -> str:
        a = cg.call(self.s1, "px", "py", "pz")
        b = cg.call(self.s2, "px", "py", "pz")
        return f"return fmaxf({a}, -{b});"

    def bounds(self) -> Box:
        return self.s1.bounds()


class Intersection(Shader3D):
    """s1 ^ s2 (cpu_evaluators.go:146, operations.go:160)."""

    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return torch.maximum(self.s1.distance(p), self.s2.distance(p))

    def emit_cuda(self, cg) -> str:
        a = cg.call(self.s1, "px", "py", "pz")
        b = cg.call(self.s2, "px", "py", "pz")
        return f"return fmaxf({a}, {b});"

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class SmoothUnion(Shader3D):
    """(cpu_evaluators.go:213, operations.go:563)."""

    PARAMS = ("k",)
    CHILDREN = ("s1", "s2")

    def __init__(self, k, s1, s2):
        self.k = _f32(k)
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        h = mx.clamp(0.5 + mx.div(0.5 * (b - a), self.k), 0.0, 1.0)
        return mx.mix(b, a, h) - mx.lit(self.k) * h * (1 - h)

    def emit_cuda(self, cg) -> str:
        k = cg.lit(self.k)
        return (
            f"float a = {cg.call(self.s1, 'px', 'py', 'pz')};\n"
            f"float b = {cg.call(self.s2, 'px', 'py', 'pz')};\n"
            f"float h = fminf(fmaxf(0.5f + 0.5f * (b - a) / {k}, 0.0f), 1.0f);\n"
            f"return (b * (1.0f - h) + a * h) - {k} * h * (1.0f - h);"
        )

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class Scale(Shader3D):
    """Uniform scale about origin (cpu_evaluators.go:288, operations.go:248)."""

    PARAMS = ("factor",)
    CHILDREN = ("s",)

    def __init__(self, s, factor):
        self.s = s
        self.factor = _f32(factor)

    def _inv(self):
        # multiply by a host float32 reciprocal, as the JAX package does
        return _f32(1.0) / self.factor

    def distance(self, p):
        return self.s.distance(p * mx.lit(self._inv())) * mx.lit(self.factor)

    def emit_cuda(self, cg) -> str:
        inv = cg.lit(self._inv())
        call = cg.call(self.s, f"px * {inv}", f"py * {inv}", f"pz * {inv}")
        return f"return {call} * {cg.lit(self.factor)};"

    def bounds(self) -> Box:
        return self.s.bounds().scale((self.factor,) * 3)


class Translate(Shader3D):
    """(cpu_evaluators.go:470, operations.go:403)."""

    PARAMS = ("p_",)
    CHILDREN = ("s",)

    def __init__(self, s, v):
        self.s = s
        self.p_ = np.asarray(v, dtype=_f32)

    def distance(self, p):
        return self.s.distance(p - mx.const(self.p_, p))

    def emit_cuda(self, cg) -> str:
        x, y, z = (cg.lit(v) for v in self.p_)
        return f"return {cg.call(self.s, f'px - {x}', f'py - {y}', f'pz - {z}')};"

    def bounds(self) -> Box:
        return self.s.bounds().add(self.p_)


class BuilderOps3:
    """3D operation constructors with reference validation rules."""

    def union(self, *shaders) -> Shader3D:
        if len(shaders) < 2:
            raise ValueError("need at least 2 arguments to union")
        joined = []
        for i, s in enumerate(shaders):
            if s is None:
                self.nilsdf(f"nil arg[{i}] to union")
            if isinstance(s, OpUnion):
                joined.extend(s.joined)
            else:
                joined.append(s)
        return OpUnion(joined)

    def difference(self, a, b) -> Shader3D:
        if a is None or b is None:
            self.nilsdf("difference")
        return Difference(a, b)

    def intersection(self, a, b) -> Shader3D:
        if a is None or b is None:
            self.nilsdf("intersection")
        return Intersection(a, b)

    def smooth_union(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_union")
        return SmoothUnion(k, s1, s2)

    def scale(self, s, factor) -> Shader3D:
        return Scale(s, factor)

    def translate(self, s, x, y, z) -> Shader3D:
        return Translate(s, (x, y, z))
