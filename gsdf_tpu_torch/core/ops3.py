"""3D CSG operations (gsdf_tpu/core/ops3.py).

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:124-549,1042-1092,1257-1274; operations.go:14-891), in
the JAX package's association. OpUnion keeps the JAX package's grouping
of identical translated subtrees (ops3.py:77-124): the subtree is
evaluated, and emitted, once and looped over a table of offsets. float32
min is exact, so the grouping changes no value.

Transform and the other domain maps use expanded float32 mul-adds,
`x*r00 + y*r01 + z*r02 + t0` left to right, never a matmul: a product
routed to a matrix unit at lower precision once cost the JAX package its
bolt and knurled goldens (gsdf_tpu/flagships.py:25-30).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.boxes import Box, mul_box3, rotation_mat2, rotation_mat4
from . import mathx as mx
from .node import NO_BOUND, Shader3D, finite

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

    def _param_groups(self):
        """The parametric kernel's grouping: ([members of one loop],
        [nodes evaluated one by one]). Translate children are grouped by
        their child's STRUCTURE, whatever its values, and every member
        keeps its own offset and its own subtree's parameters
        (gsdf_tpu/core/ops3.py:65-106): an edit of one member must show."""
        groups: dict = {}
        ordered = []
        for s in self.joined:
            if isinstance(s, Translate):
                groups.setdefault(s.s.struct_key(), []).append(s)
            else:
                ordered.append(s)
        looped = []
        for nodes in groups.values():
            if len(nodes) >= self.SCAN_THRESHOLD:
                looped.append(nodes)
            else:
                ordered.extend(nodes)
        return looped, ordered

    def param_children(self):
        looped, ordered = self._param_groups()
        return tuple(n for nodes in looped for n in nodes) + tuple(ordered)

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

    def _emit_parametric(self, cg) -> str:
        """One loop per structure group over rows of the parameter vector:
        a member's row is its Translate's slice, the offset and then its
        subtree's parameters."""
        looped, ordered = self._param_groups()
        lines = []
        terms = []
        base = 0
        for gi, nodes in enumerate(looped):
            stride = cg.slice_size(nodes[0])
            call = cg.call_at(nodes[0].s, "o + 3", "px - o[0]", "py - o[1]", "pz - o[2]")
            lines.append(
                f"float dg{gi} = {cg.lit(mx.LARGENUM)};\n"
                f"for (int g = 0; g < {len(nodes)}; ++g) {{\n"
                f"    const float* o = P + {base} + {stride} * g;\n"
                f"    dg{gi} = fminf(dg{gi}, {call});\n"
                "}"
            )
            terms.append(f"dg{gi}")
            base += stride * len(nodes)
        terms += [cg.call(s, "px", "py", "pz") for s in ordered]
        lines.append(f"float d = {terms[0]};")
        lines += [f"d = fminf(d, {t});" for t in terms[1:]]
        lines.append("return d;")
        return "\n".join(lines)

    def emit_cuda(self, cg) -> str:
        if cg.parametric:
            return self._emit_parametric(cg)
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
        return self._emit_members(cg, lines, terms, ordered)

    def _emit_members(self, cg, lines, terms, ordered, threshold=None) -> str:
        """The body's end: the members evaluated one by one, after the
        groups' loops (`lines`, their values `terms`), and the fminf chain
        in the tree's order. A threshold form (`threshold`, its t) also
        skips a bounded member whose bound exceeds t."""
        los = [cg.point_bound(s) for s in ordered[1:]]
        if ordered:  # with no loop and every other member bounded, it runs first unbounded
            alone = not terms and len(ordered) > 2 and all(los)
            los.insert(0, None if alone else cg.point_bound(ordered[0]))
        if not any(los):
            terms += [cg.call(s, "px", "py", "pz") for s in ordered]
        elif not terms and len(ordered) == 2 and all(los):
            lines.append(self._emit_either_first(cg, ordered, los))
            terms += ["t0", "t1"]
        else:
            lines.append(self._emit_bounded_last(cg, terms, ordered, los, threshold))
            terms += [f"t{i}" for i in range(len(ordered))]
        lines.append(f"float d = {terms[0]};")
        lines += [f"d = fminf(d, {t});" for t in terms[1:]]
        lines.append("return d;")
        return "\n".join(lines)

    def emit_below(self, cg, t_max):
        """The union's threshold form (Shader.emit_below): each group's loop
        walks the members that its bin table lists for the point's xy cell
        and skips those whose point bound exceeds t; a bounded member after
        the loops is skipped where its bound exceeds the running minimum or
        t (codegen/cuda.py, the module note). Stated where there is a loop
        and each loop's member has a radial bound with a reach at t_max
        (Shader.radial_bound, Shader.axis_reach)."""
        looped, ordered = self._groups()
        reaches = [child.axis_reach(t_max) for child, _ in looped]
        if not looped or any(r is None for r in reaches) or not all(finite(o) for _, o in looped):
            return None
        los = [cg.point_bound(child) for child, _ in looped]
        if not all(los):
            return None
        lines, terms = [], []
        for gi, ((child, offsets), reach, lo) in enumerate(zip(looped, reaches, los)):
            lines.append(self._emit_table_loop(cg, gi, child, offsets, reach, lo, t_max))
            terms.append(f"dg{gi}")
        return self._emit_members(cg, lines, terms, ordered, threshold="t")

    def _emit_table_loop(self, cg, gi, child, offsets, reach, lo, t_max) -> str:
        """Group gi's loop in the threshold form: the members its bin table
        walk (Codegen.table_walk) gives, each skipped where the lane took
        the table and its bound exceeds t. dg<gi> is the fminf chain over
        the members run, in the loop's order."""
        arr = cg.array(self, offsets)
        head, row = cg.table_walk(self, gi, child, offsets, reach, t_max)
        call = cg.call(child, "qx", "qy", "qz")
        return "\n".join([
            head,
            f"float dg{gi} = {cg.lit(mx.LARGENUM)};",
            f"for (int i = 0; i < n{gi}; ++i) {{",
            f"    const float* o = {arr} + 3 * ({row});",
            "    const float qx = px - o[0], qy = py - o[1], qz = pz - o[2];",
            f"    if (near{gi} && {lo}(qx, qy, qz) > t) continue;",
            f"    dg{gi} = fminf(dg{gi}, {call});",
            "}",
        ])

    def _emit_either_first(self, cg, ordered, los) -> str:
        """Two members, both bounded: the one whose bound is lower runs
        first, and the other unless the first's value undercuts its bound
        (a site each). A warp takes the order most of its lanes would
        (gsdf_warp_majority), so it runs each member at most once. One loop
        over the two positions, so each member's function is inlined once;
        its coordinates pass through gsdf_opaque, so that the compiler
        hoists no part of either member out of the loop (nvcc for sm_90a
        did, and K8 on the GEB sculpture took 122 registers, not 79). t0
        and t1 hold the members' values in the tree's order, NaN where
        skipped."""
        k = cg.union_site(self, ordered[0])
        cg.union_site(self, ordered[1])
        cg.union_helpers = True
        calls = [cg.call(s, "qx", "qy", "qz") for s in ordered]
        return "\n".join([
            f"const float l0 = {los[0]}(px, py, pz), l1 = {los[1]}(px, py, pz);",
            "const bool ordered = !isnan(px + py + pz);",
            "const int first = gsdf_warp_majority(l1 < l0);",
            "float t0 = NAN, t1 = NAN, a = NAN;",
            "#pragma unroll 1",
            "for (int i = 0; i < 2; ++i) {",
            "    const int j = i ^ first;",
            "    const float lo = j ? l1 : l0;",
            f"    if (i == 1 && GSDF_SITE({k} + j, a < lo && ordered)) break;",
            "    const float qx = gsdf_opaque(px), qy = gsdf_opaque(py), qz = gsdf_opaque(pz);",
            f"    a = j ? {calls[1]} : {calls[0]};",
            "    if (j) t1 = a; else t0 = a;",
            "}",
        ])

    def _emit_bounded_last(self, cg, terms, ordered, los, threshold=None) -> str:
        """The groups' loops (`terms`) and the members without a bound
        (`los`: the first member where all others have one) run first; then
        each bounded member in the tree's order, unless the running minimum
        `a` of what ran undercuts its bound (a site each). t<i> holds
        member i's value, NaN where skipped. In a threshold form `a` is
        also no greater than the threshold (fminf drops a NaN one)."""
        lines = [f"const float t{i} = {cg.call(s, 'px', 'py', 'pz')};"
                 for i, (s, lo) in enumerate(zip(ordered, los)) if not lo]
        ran = terms + [f"t{i}" for i, lo in enumerate(los) if not lo] + [threshold] * bool(threshold)
        lines.append(f"float a = {ran[0]};")
        lines += [f"a = fminf(a, {t});" for t in ran[1:]]
        lines.append("const bool ordered = !isnan(px + py + pz);")
        for i, (s, lo) in enumerate(zip(ordered, los)):
            if lo:
                k = cg.union_site(self, s)
                lines += [f"float t{i} = NAN;",
                          f"const float lo{i} = {lo}(px, py, pz);",
                          f"if (!GSDF_SITE({k}, a < lo{i} && ordered)) {{",
                          f"    t{i} = {cg.call(s, 'px', 'py', 'pz')};",
                          f"    a = fminf(a, t{i});",
                          "}"]
        return "\n".join(lines)

    # fminf(x, NaN) is x, so the result is NaN or one of its terms: a
    # group's loop (LARGENUM or a member at p - offset, whose bound is
    # its Translate's) or a child. So it is >= the least of LARGENUM and
    # the children's bounds, and is no NaN where a group runs (LARGENUM
    # first) or one child is NaN-free
    def lower_bound(self):
        looped, ordered = self._groups()
        terms = [c for c, _ in looped] + list(ordered)
        if not all(finite(o) for _, o in looped):
            return NO_BOUND
        return min([_f32(mx.LARGENUM)] * bool(looped) + [c.lower_bound() for c in terms])

    def nan_free(self):
        looped, ordered = self._groups()
        return bool(looped) or any(c.nan_free() for c in ordered)

    def bounds(self) -> Box:
        bb = self.joined[0].bounds()
        for s in self.joined[1:]:
            bb = bb.union(s.bounds())
        return bb


class _Binary:
    """Two-child boolean (3D and 2D); `_C` is the C expression of the
    result in the children's values `a` and `b`."""

    CHILDREN = ("s1", "s2")
    _C = ""

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def emit_cuda(self, cg) -> str:
        args = ("px", "py", "pz")[: self.NDIM]
        return (
            f"float a = {cg.call(self.s1, *args)};\n"
            f"float b = {cg.call(self.s2, *args)};\n"
            f"return {self._C};"
        )


class _Difference(_Binary):
    """s1 - s2, 3D and 2D: fmaxf(a, -b). Where the subtrahend has a
    finite lower bound lo, -b <= -lo, so wherever a > -lo the result is a
    bit for bit and the baked function returns it before it evaluates
    the subtrahend, and past that it asks the subtrahend's threshold form
    for its value only where it is below -a (Codegen.subtrahend)."""

    _C = "fmaxf(a, -b)"

    def emit_cuda(self, cg) -> str:
        args = ("px", "py", "pz")[: self.NDIM]
        return (
            f"float a = {cg.call(self.s1, *args)};\n"
            + cg.subtrahend(self, self.s1, self.s2, args)
            + f"return {self._C};"
        )

    def distance(self, p):
        return torch.maximum(self.s1.distance(p), -self.s2.distance(p))

    # fmaxf(a, -b) >= a where a is no NaN: the minuend's bound, where the
    # minuend is NaN-free (else a NaN a gives -b, which has no bound)
    def lower_bound(self):
        return self.s1.lower_bound() if self.s1.nan_free() else NO_BOUND

    def nan_free(self):
        return self.s1.nan_free() or self.s2.nan_free()

    def bounds(self) -> Box:
        return self.s1.bounds()


class _Intersection(_Binary):
    """s1 ^ s2, 3D and 2D: fmaxf(a, b)."""

    _C = "fmaxf(a, b)"

    def distance(self, p):
        return torch.maximum(self.s1.distance(p), self.s2.distance(p))

    # fmaxf(a, b) >= a where a is no NaN, and likewise b: the greater bound
    # of the NaN-free children; with neither NaN-free the result is a, b or
    # their max, so the lesser bound
    def lower_bound(self):
        free = [c.lower_bound() for c in self.children() if c.nan_free()]
        return max(free) if free else min(c.lower_bound() for c in self.children())

    def nan_free(self):
        return self.s1.nan_free() or self.s2.nan_free()

    # fmaxf(a, b) >= a where a is no NaN, and likewise b. A child's point
    # bound, where it is no NaN, holds a NaN-free child there: so the
    # greater of the children's bounds (fmaxf drops a NaN one) is one, and
    # NaN only where each child's is
    def emit_point_bound(self, cg):
        args = ", ".join(("px", "py", "pz")[: self.NDIM])
        los = [lo for lo in map(cg.point_bound, self.children()) if lo]
        if not los:
            return None
        terms = [f"{lo}({args})" for lo in los]
        return f"return {terms[0]};" if len(terms) == 1 else f"return fmaxf({', '.join(terms)});"

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class Difference(_Difference, Shader3D):
    """s1 - s2 (cpu_evaluators.go:168, operations.go:117)."""


class Intersection(_Intersection, Shader3D):
    """s1 ^ s2 (cpu_evaluators.go:146, operations.go:160)."""


class Xor(_Binary, Shader3D):
    """Exclusive-or (cpu_evaluators.go:190, operations.go:205)."""

    _C = "fmaxf(fminf(a, b), -fmaxf(a, b))"

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        return torch.maximum(torch.minimum(a, b), -torch.maximum(a, b))

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class _Smooth(Shader3D):
    """Smooth blend of two children with radius k."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s1", "s2")

    def __init__(self, k, s1, s2):
        self.k = _f32(k)
        self.s1, self.s2 = s1, s2

    def _ab(self, p):
        return self.s1.distance(p), self.s2.distance(p)

    def _head(self, cg) -> str:
        return (
            f"float a = {cg.call(self.s1, 'px', 'py', 'pz')};\n"
            f"float b = {cg.call(self.s2, 'px', 'py', 'pz')};\n"
        )


class SmoothUnion(_Smooth):
    """(cpu_evaluators.go:213, operations.go:563)."""

    def distance(self, p):
        a, b = self._ab(p)
        h = mx.clamp(0.5 + mx.div(0.5 * (b - a), self.k), 0.0, 1.0)
        return mx.mix(b, a, h) - mx.lit(self.k) * h * (1 - h)

    def emit_cuda(self, cg) -> str:
        k = cg.p(self, "k")
        return self._head(cg) + (
            f"float h = gsdf_clamp(0.5f + 0.5f * (b - a) / {k}, 0.0f, 1.0f);\n"
            f"return (b * (1.0f - h) + a * h) - {k} * h * (1.0f - h);"
        )

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class SmoothDifference(_Smooth):
    """(cpu_evaluators.go:238, operations.go:611)."""

    def distance(self, p):
        a, b = self._ab(p)
        h = mx.clamp(0.5 - mx.div(0.5 * (b + a), self.k), 0.0, 1.0)
        return mx.mix(a, -b, h) + mx.lit(self.k) * h * (1 - h)

    def emit_cuda(self, cg) -> str:
        k = cg.p(self, "k")
        return self._head(cg) + (
            f"float h = gsdf_clamp(0.5f - 0.5f * (b + a) / {k}, 0.0f, 1.0f);\n"
            f"return (a * (1.0f - h) + (-b) * h) + {k} * h * (1.0f - h);"
        )

    def bounds(self) -> Box:
        return self.s1.bounds()


class SmoothIntersect(_Smooth):
    """(cpu_evaluators.go:263, operations.go:643)."""

    def distance(self, p):
        a, b = self._ab(p)
        h = mx.clamp(0.5 - mx.div(0.5 * (b - a), self.k), 0.0, 1.0)
        return mx.mix(b, a, h) + mx.lit(self.k) * h * (1 - h)

    def emit_cuda(self, cg) -> str:
        k = cg.p(self, "k")
        return self._head(cg) + (
            f"float h = gsdf_clamp(0.5f - 0.5f * (b - a) / {k}, 0.0f, 1.0f);\n"
            f"return (b * (1.0f - h) + a * h) + {k} * h * (1.0f - h);"
        )

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class Scale(Shader3D):
    """Uniform scale about origin (cpu_evaluators.go:288, operations.go:248)."""

    PARAMS = ("factor",)
    CONT_PARAMS = ("factor",)
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
        factor = cg.p(self, "factor")
        inv = cg.expr(self._inv(), f"1.0f / {factor}")
        call = cg.call(self.s, f"px * {inv}", f"py * {inv}", f"pz * {inv}")
        return f"return {call} * {factor};"

    def bounds(self) -> Box:
        return self.s.bounds().scale((self.factor,) * 3)


class Symmetry(Shader3D):
    """Mirror about cartesian planes (cpu_evaluators.go:314, operations.go:285)."""

    PARAMS = ("mx_", "my_", "mz_")
    CHILDREN = ("s",)

    def __init__(self, s, mirror_x, mirror_y, mirror_z):
        self.s = s
        self.mx_ = bool(mirror_x)
        self.my_ = bool(mirror_y)
        self.mz_ = bool(mirror_z)

    def _mirrors(self):
        return (self.mx_, self.my_, self.mz_)

    def distance(self, p):
        cols = [torch.abs(p[..., i]) if m else p[..., i] for i, m in enumerate(self._mirrors())]
        return self.s.distance(torch.stack(cols, dim=-1))

    def emit_cuda(self, cg) -> str:
        args = [f"fabsf({a})" if m else a for a, m in zip(("px", "py", "pz"), self._mirrors())]
        return f"return {cg.call(self.s, *args)};"

    def bounds(self) -> Box:
        bb = self.s.bounds()
        lo = bb.min.copy()
        hi = bb.max.copy()
        for i, m in enumerate(self._mirrors()):
            if m:
                lo[i] = min(lo[i], -hi[i])
        return Box(lo, hi)


class Transform(Shader3D):
    """4x4 matrix transform (cpu_evaluators.go:488, operations.go:340)."""

    PARAMS = ("t",)
    #: t_inv is packed but is no PARAM: never hashed, rebuilt from t
    CONT_PARAMS = ("t", "t_inv")
    CHILDREN = ("s",)

    def __init__(self, s, t: np.ndarray):
        self.s = s
        self.t = np.asarray(t, dtype=_f32).reshape(4, 4)
        self._rebind_derived()

    def _rebind_derived(self):
        """Recompute t_inv from t: float64 inverse cast to float32, as the
        JAX package does (ops3.py:312-323)."""
        det = float(np.linalg.det(np.asarray(self.t, np.float64)))
        if abs(det) < mx.EPSTOL:
            raise ValueError("singular Mat4")
        self.t_inv = np.linalg.inv(np.asarray(self.t, np.float64)).astype(_f32)

    def distance(self, p):
        r = [[mx.lit(v) for v in row] for row in self.t_inv[:3]]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        q = torch.stack(
            [x * r[i][0] + y * r[i][1] + z * r[i][2] + r[i][3] for i in range(3)], dim=-1
        )
        return self.s.distance(q)

    def _q(self, cg) -> list:
        """The lines that map p into the child's frame, qx, qy, qz."""
        lines = []
        t_inv = cg.p(self, "t_inv")
        for i, q in enumerate(("qx", "qy", "qz")):
            r0, r1, r2, t = t_inv[4 * i : 4 * i + 4]
            lines.append(f"float {q} = px * {r0} + py * {r1} + pz * {r2} + {t};")
        return lines

    def emit_cuda(self, cg) -> str:
        return "\n".join(self._q(cg) + [f"return {cg.call(self.s, 'qx', 'qy', 'qz')};"])

    # the child's bound at the q the function computes, by the same
    # operations: the child's contract holds at any q. No nan_free: at a
    # non-NaN p with an infinite coordinate q can be NaN (inf * 0, inf - inf)
    def emit_point_bound(self, cg):
        lo = cg.point_bound(self.s)
        return lo and "\n".join(self._q(cg) + [f"return {lo}(qx, qy, qz);"])

    def bounds(self) -> Box:
        return mul_box3(self.t, self.s.bounds())


class Translate(Shader3D):
    """(cpu_evaluators.go:470, operations.go:403)."""

    PARAMS = ("p_",)
    CONT_PARAMS = ("p_",)
    CHILDREN = ("s",)

    def __init__(self, s, v):
        self.s = s
        self.p_ = np.asarray(v, dtype=_f32)

    def distance(self, p):
        return self.s.distance(p - mx.const(self.p_, p))

    def _args(self, cg) -> tuple:
        x, y, z = cg.p(self, "p_")
        return f"px - {x}", f"py - {y}", f"pz - {z}"

    def emit_cuda(self, cg) -> str:
        return f"return {cg.call(self.s, *self._args(cg))};"

    # the child's bound at the p - offset the function computes
    def emit_point_bound(self, cg):
        lo = cg.point_bound(self.s)
        return lo and f"return {lo}({', '.join(self._args(cg))});"

    # the child's threshold form at the p - offset the function computes:
    # the child's contract, at any point, is the translate's
    def emit_below(self, cg, t_max):
        below = cg.below(self.s, t_max)
        return below and f"return {below}({', '.join(self._args(cg))}, t);"

    # p - offset is no NaN at a non-NaN p where the offset is finite: the
    # child's bound and NaN-freeness carry over
    def lower_bound(self):
        return self.s.lower_bound() if finite(self.p_) else NO_BOUND

    def nan_free(self):
        return finite(self.p_) and self.s.nan_free()

    def bounds(self) -> Box:
        return self.s.bounds().add(self.p_)


class Offset(Shader3D):
    """Add sdfAdd to the SDF (cpu_evaluators.go:454, operations.go:446)."""

    PARAMS = ("off",)
    CONT_PARAMS = ("off",)
    CHILDREN = ("s",)

    def __init__(self, s, off):
        self.s = s
        self.off = _f32(off)

    def distance(self, p):
        return self.s.distance(p) + mx.lit(self.off)

    def emit_cuda(self, cg) -> str:
        return f"return {cg.call(self.s, 'px', 'py', 'pz')} + {cg.p(self, 'off')};"

    # With off finite: where the child's bound lo is no NaN, so is lo + off,
    # and the child's value c >= lo is no NaN, so c + off is no NaN and
    # >= fl(lo + off) (rounding is monotone); and lo + off is NaN where lo
    # is. A NaN-free child stays NaN-free: c + off with c no NaN and off
    # finite is no NaN
    def emit_point_bound(self, cg):
        lo = cg.point_bound(self.s)
        if lo is None or not finite(self.off):
            return None
        return f"return {lo}(px, py, pz) + {cg.lit(self.off)};"

    def nan_free(self):
        return finite(self.off) and self.s.nan_free()

    def bounds(self) -> Box:
        bb = self.s.bounds()
        return Box(bb.min + self.off, bb.max - self.off).canon()


def _array_distance(s, p, spacing, counts):
    """Limited grid repetition over p's last axis (Array, Array2D): the
    child at the 2^n candidate tiles nearest p, min-reduced."""
    spacing = mx.const(spacing, p)
    lo = mx.const(np.zeros(len(counts)), p)
    hi = mx.const(np.asarray(counts, _f32) - 1, p)
    pid = mx.round_half_away(p / spacing)
    o = mx.sign(p - spacing * pid)
    d = torch.full(p.shape[:-1], mx.LARGENUM, dtype=torch.float32, device=p.device)
    ndim = p.shape[-1]
    for t in range(1 << ndim):
        # tile order of the JAX package: x fastest
        step = mx.const([(t >> a) & 1 for a in range(ndim)], p)
        rid = torch.clamp(pid + step * o, lo, hi)
        d = torch.minimum(d, s.distance(p - spacing * rid))
    return d


def _emit_array(cg, node, counts) -> str:
    axes = ("x", "y", "z")[: len(counts)]
    lines = []
    for a, sp, n in zip(axes, cg.p(node, "d"), counts):
        lines.append(f"const float s{a} = {sp}, n{a} = {cg.lit(n - 1)};")
        lines.append(f"const float pid{a} = gsdf_round_half_away(p{a} / s{a});")
        lines.append(f"const float o{a} = gsdf_sign(p{a} - s{a} * pid{a});")
    lines.append(f"float d = {cg.lit(mx.LARGENUM)};")
    lines.append(f"for (int t = 0; t < {1 << len(axes)}; ++t) {{")
    args = []
    for i, a in enumerate(axes):
        lines.append(
            f"    const float r{a} = gsdf_clamp(pid{a} + (float)((t >> {i}) & 1) * o{a}, 0.0f, n{a});"
        )
        args.append(f"p{a} - s{a} * r{a}")
    lines.append(f"    d = fminf(d, {cg.call(node.s, *args)});")
    lines.append("}")
    lines.append("return d;")
    return "\n".join(lines)


class Array(Shader3D):
    """Limited grid domain repetition (cpu_evaluators.go:345, operations.go:488).

    Evaluates the child at the 8 candidate neighbouring tiles and
    min-reduces; the generated C loops over one child function."""

    PARAMS = ("d", "nx", "ny", "nz")
    CONT_PARAMS = ("d",)
    CHILDREN = ("s",)

    def __init__(self, s, d, nx, ny, nz):
        self.s = s
        self.d = np.asarray(d, dtype=_f32)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)

    def _counts(self):
        return (self.nx, self.ny, self.nz)

    def distance(self, p):
        return _array_distance(self.s, p, self.d, self._counts())

    def emit_cuda(self, cg) -> str:
        return _emit_array(cg, self, self._counts())

    def bounds(self) -> Box:
        bb = self.s.bounds()
        size = np.array(self._counts(), _f32) * self.d
        return Box(bb.min, bb.max + size)


def _elongate_distance(s, p, h):
    """Elongate and Elongate2D: child at max(|p| - h/2, 0) plus the inside
    term min(max over axes, 0)."""
    q = torch.abs(p) - mx.const(h * _f32(0.5), p)
    w = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return s.distance(torch.clamp(q, min=0.0)) + w


def _emit_elongate(cg, node) -> str:
    axes = ("x", "y", "z")[: len(node.h)]
    lines = [
        f"const float q{a} = fabsf(p{a}) - {cg.expr(v, f'{h} * 0.5f')};"
        for a, v, h in zip(axes, node.h * _f32(0.5), cg.p(node, "h"))
    ]
    w = f"q{axes[-1]}"
    for a in reversed(axes[:-1]):
        w = f"fmaxf(q{a}, {w})"
    call = cg.call(node.s, *(f"fmaxf(q{a}, 0.0f)" for a in axes))
    lines.append(f"return {call} + fminf({w}, 0.0f);")
    return "\n".join(lines)


class Elongate(Shader3D):
    """(cpu_evaluators.go:399, operations.go:679)."""

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


class Shell(Shader3D):
    """Exterior shell (cpu_evaluators.go:428, operations.go:723)."""

    PARAMS = ("thick",)
    CONT_PARAMS = ("thick",)
    CHILDREN = ("s",)

    def __init__(self, s, thickness):
        self.s = s
        self.thick = _f32(thickness)

    def distance(self, p):
        t = mx.lit(self.thick)
        d = self.s.distance(p * mx.lit(_f32(1.0) / self.thick))
        return t * (torch.abs(d) - t)

    def emit_cuda(self, cg) -> str:
        t = cg.p(self, "thick")
        inv = cg.expr(_f32(1.0) / self.thick, f"1.0f / {t}")
        call = cg.call(self.s, f"px * {inv}", f"py * {inv}", f"pz * {inv}")
        return f"return {t} * (fabsf({call}) - {t});"

    def bounds(self) -> Box:
        return self.s.bounds()


class _Circular:
    """Circular domain repetition about the origin (CircularArray and
    CircularArray2D, cpu_evaluators.go:1042,1094): the child evaluated
    at the two instances nearest p's angle, min-reduced. Instance i is p
    rotated by -i * angle (MulMatVecTrans(RotationMat2(a), p))."""

    PARAMS = ("n_inst", "circle_div")
    CHILDREN = ("s",)

    def __init__(self, s, num_instances, circle_div):
        self.s = s
        self.n_inst = int(num_instances)
        self.circle_div = int(circle_div)

    def _consts(self):
        return (
            _f32(2 * math.pi / self.circle_div),
            _f32(self.circle_div),
            _f32(self.n_inst - 1),
        )

    def _instances(self, x, y):
        """[(x0, y0), (x1, y1)]: p in the frames of its two instances."""
        angle, ncirc, ninsm1 = (mx.lit(v) for v in self._consts())
        pid = torch.floor(mx.div(mx.atan2(y, x), angle))
        pid = torch.where(pid < 0, pid + ncirc, pid)
        last = pid >= ninsm1
        out = []
        for i in (torch.where(last, ninsm1, pid), torch.where(last, 0.0, pid + 1.0)):
            a = angle * i
            c, s = mx.cos(a), mx.sin(a)
            out.append((c * x + s * y, -s * x + c * y))
        return out

    def _emit(self, cg, z: tuple) -> str:
        angle, ncirc, ninsm1 = (cg.lit(v) for v in self._consts())
        calls = [cg.call(self.s, f"c{i} * px + s{i} * py", f"-s{i} * px + c{i} * py", *z)
                 for i in (0, 1)]
        return (
            f"float pid = floorf(atan2f(py, px) / {angle});\n"
            f"pid = pid < 0.0f ? pid + {ncirc} : pid;\n"
            f"const bool last = pid >= {ninsm1};\n"
            f"const float a0 = {angle} * (last ? {ninsm1} : pid);\n"
            f"const float a1 = {angle} * (last ? 0.0f : pid + 1.0f);\n"
            "const float c0 = cosf(a0), s0 = sinf(a0);\n"
            "const float c1 = cosf(a1), s1 = sinf(a1);\n"
            f"return fminf({calls[0]}, {calls[1]});"
        )

    def _rotated_bounds(self, bb: Box) -> Box:
        verts = bb.vertices()
        m = rotation_mat2(2 * math.pi / self.circle_div)
        for _ in range(self.n_inst - 1):
            verts = verts @ m.T
            for v in verts:
                bb = bb.include_point(v)
        return bb


class CircularArray(_Circular, Shader3D):
    """Circular domain repetition about z through origin; child evaluated
    exactly twice regardless of instance count
    (cpu_evaluators.go:1042, operations.go:764)."""

    def distance(self, p):
        z = p[..., 2]
        d0, d1 = (
            self.s.distance(torch.stack([x, y, z], dim=-1))
            for x, y in self._instances(p[..., 0], p[..., 1])
        )
        return torch.minimum(d0, d1)

    def emit_cuda(self, cg) -> str:
        return self._emit(cg, ("pz",))

    def bounds(self) -> Box:
        bb = self.s.bounds()
        bb2 = self._rotated_bounds(Box(bb.min[:2].copy(), bb.max[:2].copy()))
        lo = bb.min.copy()
        hi = bb.max.copy()
        lo[:2] = bb2.min
        hi[:2] = bb2.max
        return Box(lo, hi)


class Twist(Shader3D):
    """Twist about z: XY rotated by k*z at height z
    (cpu_evaluators.go:1257, operations.go:835)."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s",)

    def __init__(self, s, k):
        self.s = s
        self.k = _f32(k)

    def distance(self, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        a = mx.lit(self.k) * z
        c, s = mx.cos(a), mx.sin(a)
        return self.s.distance(torch.stack([c * x - s * y, s * x + c * y, z], dim=-1))

    def emit_cuda(self, cg) -> str:
        call = cg.call(self.s, "c * px - s * py", "s * px + c * py", "pz")
        return (
            f"const float a = {cg.p(self, 'k')} * pz;\n"
            "const float c = cosf(a), s = sinf(a);\n"
            f"return {call};"
        )

    def bounds(self) -> Box:
        bb = self.s.bounds()
        verts = bb.vertices()
        max_r = float(np.max(np.hypot(verts[:, 0], verts[:, 1])))
        return Box(
            np.array([-max_r, -max_r, bb.min[2]], _f32),
            np.array([max_r, max_r, bb.max[2]], _f32),
        )


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

    def xor(self, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("xor")
        return Xor(s1, s2)

    def smooth_union(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_union")
        return SmoothUnion(k, s1, s2)

    def smooth_difference(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_difference")
        return SmoothDifference(k, s1, s2)

    def smooth_intersect(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_intersect")
        return SmoothIntersect(k, s1, s2)

    def scale(self, s, factor) -> Shader3D:
        return Scale(s, factor)

    def symmetry(self, s, mirror_x=False, mirror_y=False, mirror_z=False) -> Shader3D:
        if not (mirror_x or mirror_y or mirror_z):
            self.shape_error("ineffective symmetry")
        return Symmetry(s, mirror_x, mirror_y, mirror_z)

    def transform(self, s, mat4) -> Shader3D:
        try:
            return Transform(s, mat4)
        except ValueError as e:
            self.shape_error(str(e))
            return Transform(s, np.eye(4, dtype=_f32))

    def rotate(self, s, radians, axis) -> Shader3D:
        axis = np.asarray(axis, dtype=_f32)
        if not np.any(axis):
            self.shape_error("null vector")
        return self.transform(s, rotation_mat4(radians, axis))

    def translate(self, s, x, y, z) -> Shader3D:
        return Translate(s, (x, y, z))

    def offset(self, s, sdf_add) -> Shader3D:
        return Offset(s, sdf_add)

    def array(self, s, spacing_x, spacing_y, spacing_z, nx, ny, nz) -> Shader3D:
        if nx <= 0 or ny <= 0 or nz <= 0:
            self.shape_error("invalid array repeat param")
        if spacing_x <= 0 or spacing_y <= 0 or spacing_z <= 0:
            self.shape_error("invalid array spacing")
        return Array(s, (spacing_x, spacing_y, spacing_z), nx, ny, nz)

    def elongate(self, s, dir_x, dir_y, dir_z) -> Shader3D:
        return Elongate(s, (dir_x, dir_y, dir_z))

    def shell(self, s, thickness) -> Shader3D:
        return Shell(s, thickness)

    def circular_array(self, s, num_instances, circle_div) -> Shader3D:
        if s is None:
            self.nilsdf("circular_array")
        if circle_div <= 1 or num_instances <= 0:
            self.shape_error("invalid circarray repeat param")
        if num_instances > circle_div:
            self.shape_error(
                "bad circular array instances, must be less than or equal to circle_div"
            )
        return CircularArray(s, num_instances, circle_div)

    def twist(self, s, k) -> Shader3D:
        if s is None:
            self.nilsdf("twist")
        if k == 0:
            self.shape_error("zero twist parameter")
        return Twist(s, k)
