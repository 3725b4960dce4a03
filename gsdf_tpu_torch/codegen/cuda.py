"""Per-tree CUDA C codegen: SDF tree -> one scalar distance function per
node, the counterpart of the reference's GLSL Programmer
(glbuild/glbuild.go:299-396) and of gsdf_tpu/visual/glsl.py.

- Each node's body comes from its `emit_cuda` hook; functions are named
  `<kind>_<tree-hash prefix>`, so structurally identical subtrees share a
  name and are emitted once (the showerhead's 130 hole instances are one
  cylinder function behind one offset table).
- Emission is post-order (children first), so every callee is declared
  before its caller.
- Polygon edge tables and OpUnion translate-group offsets become
  `GSDF_CONST float` arrays; they replace the JAX package's jaxpr-constant
  hoisting into kernel operands (gsdf_tpu/eval/pallas_grid.py:59-100).
- Float literals round-trip float32 exactly (`%.9g` + `f`), so no
  expression is promoted to double and no constant drifts by an ulp.
- The source is plain C++ under the GSDF_HD / GSDF_CONST macros: nvcc
  builds it into the grid kernels (csrc/), and g++ builds the very same
  text for the CPU test of the emitters.

Short circuits (baked mode). A Difference is fmaxf(a, -b). Where its
subtrahend's class states a finite lower bound lo (`Shader.lower_bound`,
derived beside each class from its own float32 operations), -b <= -lo,
so wherever a > -lo the result is a bit for bit, and the function returns
a before it evaluates b: the showerhead's 131 hole cylinders (lo = -0.8)
run only where the plate's distance is 0.8 or less. The test is strict,
so a tie, a signed zero and a NaN a take the full path, and so does a
point with a NaN coordinate (lo holds at non-NaN points). Each such test
is a site, numbered in emission order and wrapped as GSDF_SITE(k, skip);
the source defines GSDF_NSITES and GSDF_SITE(k, skip) as `(skip)` unless
the includer has defined it (csrc/raymarch_sites.cu counts each site's
skips). A tree with no Difference over a bounded subtrahend and no union
site (below), and every parametric source, has no site and no such lines.

Union sites (baked mode). A union is fminf of its members in the tree's
order. A class may state a point bound (`Shader.emit_point_bound`): a
function lo(p) of its coordinates such that wherever lo(p) is no NaN the
node's value is no NaN and >= lo(p). Where the members that ran already
give a running minimum a < lo(p) of a bounded member, that member's value
is > a or NaN, so the union's result cannot be it: the member is skipped
and its term is NaN, which fminf drops. The fminf chain over the terms in
the tree's order is then the same, bit for bit: until the first term
below the skipped value both chains hold values no smaller than it (or
NaN), and from that term on they are equal. Members without a bound (and
OpUnion's translate-group loops) run first; of two members both bounded,
the one whose bound is lower in most of a warp's lanes runs first, in
all of them (a loop over the two positions, each member inlined once).
Each bounded member is a site, named after the
union's and the member's functions: a union of extruded letters (the GEB
sculpture) skips the half that lies beyond the nearer half's value.

Threshold forms (baked mode). Past its site a Difference needs its
subtrahend's value b only where -b could exceed a, that is where b < -a.
Where the subtrahend states a threshold form (`Shader.emit_below`,
`<function>_below(px, py, pz, t)`: its value bit for bit wherever that
is <= t or t is NaN, elsewhere a value > t), the Difference calls it
with t = -a, and fmaxf(a, -b) is the same bit for bit: where b <= -a the
form returns b; elsewhere both b and the form's value exceed -a, so -b
and its negation lie below a, and the result is a. An OpUnion with a
translate-group loop states one (Translate passes it through) where
each loop's member states a radial bound (`Shader.radial_bound`, a point
bound on the distance from its axis: a Cylinder), from which its reach
(`Shader.axis_reach`) follows: a member whose bound exceeds t cannot be
at or below t, so it is skipped, and the fminf chain over the members
run, in the loop's order and then the tree's, is the same bit for bit
where the union is <= t (the argument of the union sites above, every
skipped member lying above the minimum); a bounded member after the loop
is skipped where its bound exceeds the running minimum or t. The loop
walks only the members that a baked xy bin table (`bin_table`, emitted
with the walk's lines by `Codegen.table_walk`) lists for the point's
cell: those whose axis comes within the member's reach at t_max, minus
the minuend's lower bound, of some point of the cell. It takes the table
where t <= t_max and px + py is no NaN; a point outside the grid lies
beyond every member's reach and walks none; elsewhere it walks the whole
loop and skips nothing. Each loop is named "<union>/<member>*<members>",
numbered in emission order and wrapped as GSDF_TABLE(k, near) (whether
the lane takes the table) and GSDF_LOOP(k, n) (the members it walks);
the source defines GSDF_NLOOPS and both, as `(near)` and nothing, unless
the includer has (csrc/raymarch_sites.cu counts each loop's walks). The
showerhead's plate runs its 131-hole union as a table walk of at most a
few holes.

Edge loops. A polygon's function is one loop over a baked table of its
edges (`Polygon2D.emit_cuda`), numbered in emission order and wrapped as
GSDF_EDGES(k) before the loop, GSDF_EDGE(k, divide) around the test that
decides whether an edge divides, and GSDF_EDGES_DONE(k, n) after its n
edges; the source defines GSDF_NPOLYGONS and the three, as nothing,
`(divide)` and nothing, unless the includer has (csrc/raymarch_sites.cu
counts each loop's edges and divisions). Parametric sources have them
too: the edge table is structural.

`tree_source(tree)` ends with the root function the kernel templates call,
`gsdf_tree(px, py, pz)` for a 3D tree and `gsdf_tree(px, py)` for a 2D one,
and defines GSDF_NDIM (3 or 2) so that a template can tell which it got.

Two modes. Baked (the default): every parameter is a float literal and
functions are shared by `tree_hash`. Parametric (`tree_source(tree,
parametric=True)`): each continuous parameter (a node class's
CONT_PARAMS) is read from a float32 vector, so one source serves every
tree of the same structure and an edited part needs no new build.

- Every function takes `const float* P` first: the slice of its own
  subtree, its own continuous parameters (CONT_PARAMS order, flattened)
  followed by each child's slice in `param_children()` order. A child is
  called with `P + k`, k known here, so functions are named and shared by
  `struct_key` and two subtrees of one structure differ only in the slice
  they read. `codegen/params.py::kernel_index` lays a tree's vector out
  the same way.
- A constant that the baked emitter derives on the host in numpy float32
  (`dims * 0.5`, `1 / factor`) is computed in the kernel by the same
  float32 operations in the same order on the value read (`expr`). They
  are IEEE operations and nothing contracts them, so a parametric kernel
  equals the baked one bit for bit.
- Structural parameters, constant tables (polygon edges, displacement
  tables) and every Python branch of an emitter stay as in the baked mode.
- The source defines GSDF_PARAMETRIC, GSDF_NPARAMS (the vector's length,
  fixed by the structure) and GSDF_PARAMS_BY_VALUE (whether the templates
  take the vector by value as a kernel parameter or as a device pointer),
  and `gsdf_tree(P, px, py, pz)`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..core.mathx import CBRT_MAGIC, CBRT_STEPS, COS_ACOS_3_COEFFS
from ..core.node import NO_BOUND, Shader

PRELUDE = """\
// generated by gsdf_tpu_torch.codegen.cuda -- do not edit
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#ifdef __CUDACC__
#define GSDF_HD static __device__ __forceinline__
#define GSDF_CONST static __device__ const
#else
#define GSDF_HD static inline
#define GSDF_CONST static const
#endif

// the helpers of gsdf_tpu_torch/core/mathx.py, operation for operation
GSDF_HD float gsdf_sign(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }
GSDF_HD float gsdf_clamp(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
GSDF_HD float gsdf_round_half_away(float x) { return gsdf_sign(x) * floorf(fabsf(x) + 0.5f); }
GSDF_HD float gsdf_cos_acos_3(float x) {
    x = sqrtf(0.5f + 0.5f * x);
    return x * (x * (x * (x * %(c0)s + %(c1)s) - %(c2)s) + %(c3)s) + 0.5f;
}
GSDF_HD float gsdf_cbrt(float x) {  // x >= 0
    if (x == 0.0f || isinf(x)) return x;
    int32_t bits;
    memcpy(&bits, &x, sizeof bits);
    bits = bits / 3 + %(cbrt_magic)d;
    float y;
    memcpy(&y, &bits, sizeof y);
    for (int i = 0; i < %(cbrt_steps)d; ++i) y = y - (y * y * y - x) / (3.0f * y * y);
    return y;
}
"""


#: what a two-member union site needs (ops3.OpUnion._emit_either_first),
#: in the sources that have one: a warp-uniform choice, and a value the
#: compiler cannot see through (both the identity off the card)
UNION_HELPERS = """\
GSDF_HD bool gsdf_warp_majority(bool x) {
#ifdef __CUDA_ARCH__
    const unsigned m = __activemask();
    return 2 * __popc(__ballot_sync(m, x)) > __popc(m);
#else
    return x;
#endif
}
GSDF_HD float gsdf_opaque(float x) {
#ifdef __CUDA_ARCH__
    asm volatile("" : "+f"(x));
#endif
    return x;
}
"""


def lit(x) -> str:
    """A C float literal that parses back to exactly float32(x)."""
    v = np.float32(x)
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    if math.isnan(v):
        raise ValueError("NaN constant in an SDF tree")
    s = "%.9g" % float(v)
    if not any(ch in s for ch in ".e"):
        s += ".0"
    s += "f"
    return f"({s})" if s.startswith("-") else s


PRELUDE = PRELUDE % {
    "cbrt_magic": CBRT_MAGIC,
    "cbrt_steps": CBRT_STEPS,
    # Python floats rounded to float32 once, as the JAX package's weak types
    **{f"c{i}": lit(c) for i, c in enumerate(COS_ACOS_3_COEFFS)},
}


class Codegen:
    """Collects the functions and constant arrays of one tree, baked or
    parametric (see the module note)."""

    def __init__(self, parametric: bool = False):
        self.parametric = parametric
        self._names: dict = {}  # tree hash / struct key -> function name
        self._chunks: list = []  # emitted arrays and functions, in order
        self._n_arrays: dict = {}  # function name -> arrays emitted
        self._stack: list = []  # nodes whose bodies are being emitted
        self._sizes: dict = {}  # id(node) -> floats in its subtree's slice
        self._bounds: dict = {}  # tree hash -> point-bound function name or None
        self._belows: dict = {}  # (tree hash, t_max) -> threshold-form name or None
        self._arrays: dict = {}  # (function, C type, values) -> array name
        self.union_helpers = False  # the source needs UNION_HELPERS
        #: the short-circuit sites, in their GSDF_SITE order: (the site's
        #: name, the function it skips, the bound: the Difference's
        #: subtrahend's lower bound, or None for a union member's point
        #: bound). A Difference's site is named by its function, a union's
        #: as "<union's function>/<member's function>"
        self.sites: list = []
        #: the translate-group loops of threshold forms, in their GSDF_TABLE
        #: and GSDF_LOOP order: (the loop's name, the member's function,
        #: the members)
        self.loops: list = []
        #: the polygons' edge loops, in their GSDF_EDGES order: (the
        #: polygon's function, its edges)
        self.polygons: list = []

    @staticmethod
    def lit(x) -> str:
        return lit(x)

    def _key(self, node: Shader) -> bytes:
        return node.struct_key() if self.parametric else node.tree_hash()

    def name(self, node: Shader) -> str:
        return f"{type(node).__name__.lower()}_{self._key(node).hex()[:12]}"

    # --- the parameter vector's layout (parametric mode) ----------------
    @staticmethod
    def own_size(node: Shader) -> int:
        """Floats of `node`'s own continuous parameters."""
        return sum(int(np.size(getattr(node, n))) for n in node.CONT_PARAMS)

    def slice_size(self, node: Shader) -> int:
        """Floats of `node`'s subtree: its own, then each child's slice."""
        size = self._sizes.get(id(node))
        if size is None:
            size = self.own_size(node) + sum(self.slice_size(c) for c in node.param_children())
            self._sizes[id(node)] = size
        return size

    def child_offset(self, child: Shader) -> int:
        """Where `child`'s slice starts in the slice of the node being
        emitted."""
        node = self._stack[-1]
        k = self.own_size(node)
        for c in node.param_children():
            if c is child:
                return k
            k += self.slice_size(c)
        raise ValueError(f"{type(child).__name__} is no child of {type(node).__name__}")

    # --- what an emitter writes its body with ---------------------------
    def p(self, node: Shader, name: str):
        """The C expression(s) of `node`'s parameter `name`: one string
        for a scalar, a flat list for an array. A literal, except for a
        continuous parameter in parametric mode, which is `P[k]`."""
        value = getattr(node, name)
        flat = np.asarray(value, np.float32).reshape(-1)
        if self.parametric and name in node.CONT_PARAMS:
            if node is not self._stack[-1]:
                raise ValueError("an emitter reads only its own node's parameters")
            k = 0
            for n in node.CONT_PARAMS:
                if n == name:
                    break
                k += int(np.size(getattr(node, n)))
            out = [f"P[{k + i}]" for i in range(len(flat))]
        else:
            out = [lit(v) for v in flat]
        return out if np.ndim(value) else out[0]

    def expr(self, value, text: str) -> str:
        """A constant derived from continuous parameters: the literal of
        `value` (numpy float32, computed on the host) in baked mode, in
        parametric mode `text`, the C expression that does the same float32
        operations in the same order on the parameters' `p()` strings."""
        return f"({text})" if self.parametric else lit(value)

    def array(self, node: Shader, values, align: int = 0) -> str:
        """Emit a float32 constant table for `node` (once for equal
        values); returns its name. With `align` (bytes) the table starts
        on that boundary, for wide loads, and each row of the 2D `values`
        is a line of its own."""
        values = np.asarray(values, np.float32)
        per_row = values.shape[-1] if align else 4
        return self._table(node, "float", [lit(v) for v in values.reshape(-1)], per_row, align)

    def int_array(self, node: Shader, values) -> str:
        """Emit a constant table of non-negative integers for `node`, in
        the narrowest C type that holds them; returns its name."""
        flat = [int(v) for v in np.asarray(values).reshape(-1)]
        top = max(flat, default=0)
        ctype = "unsigned char" if top < 2**8 else "unsigned short" if top < 2**16 else "int"
        return self._table(node, ctype, [str(v) for v in flat], 16)

    def _table(self, node: Shader, ctype: str, items: list, per_row: int, align: int = 0) -> str:
        fn = self.name(node)
        key = (fn, ctype, tuple(items), align)
        if key in self._arrays:
            return self._arrays[key]
        i = self._n_arrays.get(fn, 0)
        self._n_arrays[fn] = i + 1
        name = self._arrays[key] = f"{fn}_c{i}"
        body = ",\n    ".join(
            ", ".join(items[r : r + per_row]) for r in range(0, len(items), per_row)
        )
        aligned = f"alignas({align}) " if align else ""
        self._chunks.append(
            f"{aligned}GSDF_CONST {ctype} {name}[{len(items)}] = {{\n    {body}\n}};")
        return name

    def call(self, node: Shader, *args: str) -> str:
        """A call of child `node`'s function on `args`, emitting it on
        first use; in parametric mode the child's slice goes first."""
        if self.parametric:
            k = self.child_offset(node)
            return self.call_at(node, f"P + {k}" if k else "P", *args)
        return f"{self.emit(node)}({', '.join(args)})"

    def call_at(self, node: Shader, params: str, *args: str) -> str:
        """Parametric mode: a call of `node`'s function on the slice that
        the C expression `params` points to."""
        return f"{self.emit(node)}({', '.join((params,) + args)})"

    def subtrahend(self, node: Shader, minuend: Shader, sub: Shader, args) -> str:
        """The lines of a Difference `node`'s body, after its minuend's value
        `a`, that give its subtrahend's value `b`: in baked mode with a
        finite `sub.lower_bound()` first a line that returns `a` where `sub`
        cannot change the result, then, where the minuend has a finite
        lower bound and `sub` a threshold form, b from that form at t = -a
        (the module note). `args` are the function's coordinates."""
        lo = np.float32(NO_BOUND if self.parametric else sub.lower_bound())
        if not np.isfinite(lo):
            return f"float b = {self.call(sub, *args)};\n"
        t_max = -np.float32(minuend.lower_bound())
        below = self.below(sub, t_max) if np.isfinite(t_max) else None
        fn = below or self.emit(sub)  # its own sites first
        k = len(self.sites)
        self.sites.append((self.name(node), self.name(sub), lo))
        call = f"{fn}({', '.join(args)}, -a)" if below else self.call(sub, *args)
        ordered = f"!isnan({' + '.join(args)})"
        return (f"if (GSDF_SITE({k}, a > {lit(-lo)} && {ordered})) return a;\n"
                f"float b = {call};\n")

    def below(self, node: Shader, t_max) -> str | None:
        """The name of `node`'s threshold form for thresholds up to the
        float32 `t_max` (`emit_below`, `<function>_below` of the node's
        coordinates and t), emitted on first use; None where its class
        states none, and in parametric mode."""
        if self.parametric:
            return None
        t_max = np.float32(t_max)
        key = (node.tree_hash(), t_max.tobytes())
        if key not in self._belows:
            self._stack.append(node)
            try:
                body = node.emit_below(self, t_max)  # emits the children's first
            finally:
                self._stack.pop()
            name = f"{self.name(node)}_below"
            n = sum(1 for (h, _), fn in self._belows.items() if h == key[0] and fn)
            self._belows[key] = body and self._function(name + (f"{n}" if n else ""), node,
                                                        body, "float t")
        return self._belows[key]

    def loop_site(self, node: Shader, member: Shader, n: int) -> int:
        """Number a translate-group loop of `node`'s threshold form over n
        copies of `member` (the module note); returns its GSDF_TABLE and
        GSDF_LOOP index."""
        fn = self.emit(member)
        name = f"{self.name(node)}/{fn}*{n}"
        if any(site == name for site, _, _ in self.loops):
            name += f"#{len(self.loops)}"
        self.loops.append((name, fn, n))
        return len(self.loops) - 1

    def table_walk(self, node: Shader, gi: int, member: Shader, offsets, reach, t_max) -> tuple:
        """Group gi of union `node`'s threshold form, a loop over `member`
        translated by `offsets`: emits its bin table (`bin_table` of the
        offsets' xy at `reach`) and numbers the loop (`loop_site`). Returns
        the lines that set near<gi> (the lane takes the table: t <= the
        float32 `t_max` and px + py no NaN, through GSDF_TABLE), i<gi> and
        n<gi> (where its cell's list starts and how many members it walks:
        none outside the grid, all where it does not take the table), then
        GSDF_LOOP's note; and the C expression of the offsets' row of the
        i-th member walked (the module note)."""
        table = bin_table(offsets[:, :2], reach)
        starts, ids = self.int_array(node, table.starts), self.int_array(node, table.ids)
        k = self.loop_site(node, member, len(offsets))
        (x0, y0), (nx, ny) = table.origin, table.shape
        inv = lit(1.0 / table.cell)
        head = "\n".join([
            f"int i{gi} = 0, n{gi} = {len(offsets)};",
            f"const bool near{gi} = GSDF_TABLE({k}, t <= {lit(t_max)} && !isnan(px + py));",
            f"if (near{gi}) {{",
            f"    const float fx = (px - {lit(x0)}) * {inv}, fy = (py - {lit(y0)}) * {inv};",
            f"    n{gi} = 0;",
            f"    if (fx >= 0.0f && fx < {lit(nx)} && fy >= 0.0f && fy < {lit(ny)}) {{",
            f"        const int c = (int)fy * {nx} + (int)fx;",
            f"        i{gi} = {starts}[c];",
            f"        n{gi} = {starts}[c + 1] - i{gi};",
            "    }",
            "}",
            f"GSDF_LOOP({k}, n{gi});",
        ])
        return head, f"near{gi} ? {ids}[i{gi} + i] : i"

    def edge_loop(self, node: Shader, n: int) -> int:
        """Number the edge loop of polygon `node`'s function, n edges (the
        module note); returns its GSDF_EDGES index."""
        self.polygons.append((self.name(node), n))
        return len(self.polygons) - 1

    def point_bound(self, node: Shader) -> str | None:
        """The name of `node`'s point-bound function (`emit_point_bound`,
        `<function>_lo` of the node's coordinates), emitted on first use;
        None where its class states none, and in parametric mode."""
        if self.parametric:
            return None
        key = node.tree_hash()
        if key not in self._bounds:
            self._stack.append(node)
            try:
                body = node.emit_point_bound(self)  # emits the children's first
            finally:
                self._stack.pop()
            self._bounds[key] = body and self._function(f"{self.name(node)}_lo", node, body)
        return self._bounds[key]

    def union_site(self, node: Shader, member: Shader) -> int:
        """Number a site of union `node` that skips `member` where the
        members run before it undercut the member's point bound (the
        module note); returns its GSDF_SITE index."""
        fn = self.emit(member)
        name = f"{self.name(node)}/{fn}"
        if any(site == name for site, _, _ in self.sites):  # a member twice
            name += f"#{len(self.sites)}"
        self.sites.append((name, fn, None))
        return len(self.sites) - 1

    def _function(self, name: str, node: Shader, body: str, *extra: str) -> str:
        """Append the function `name` of `node`'s coordinates (and the
        parameters `extra`) with `body`."""
        params = ("float px", "float py", "float pz")[: node.NDIM] + extra
        if self.parametric:
            params = ("const float* P",) + params
        indented = "\n".join("    " + ln for ln in body.splitlines())
        self._chunks.append(f"GSDF_HD float {name}({', '.join(params)}) {{\n{indented}\n}}")
        return name

    def emit(self, node: Shader) -> str:
        key = self._key(node)
        name = self._names.get(key)
        if name is not None:
            return name
        self._stack.append(node)
        try:
            body = node.emit_cuda(self)  # emits children and arrays first
        finally:
            self._stack.pop()
        self._names[key] = self._function(self.name(node), node, body)
        return self._names[key]

    def source(self) -> str:
        sites = ""
        if self.sites:
            sites = (
                f"#undef GSDF_NSITES\n#define GSDF_NSITES {len(self.sites)}\n"
                "#ifndef GSDF_SITE\n#define GSDF_SITE(k, skip) (skip)\n#endif\n"
            )
        if self.loops:
            sites += (
                f"#undef GSDF_NLOOPS\n#define GSDF_NLOOPS {len(self.loops)}\n"
                "#ifndef GSDF_TABLE\n#define GSDF_TABLE(k, near) (near)\n#endif\n"
                "#ifndef GSDF_LOOP\n#define GSDF_LOOP(k, n) ((void)0)\n#endif\n"
            )
        if self.polygons:
            sites += (
                f"#undef GSDF_NPOLYGONS\n#define GSDF_NPOLYGONS {len(self.polygons)}\n"
                "#ifndef GSDF_EDGE\n#define GSDF_EDGES(k) ((void)0)\n"
                "#define GSDF_EDGE(k, divide) (divide)\n"
                "#define GSDF_EDGES_DONE(k, n) ((void)0)\n#endif\n"
            )
        if self.union_helpers:
            sites += UNION_HELPERS
        return PRELUDE + sites + "\n" + "\n\n".join(self._chunks) + "\n"


#: a bin table's cell is the power of two nearest the loop members' reach,
#: doubled until the grid has at most BIN_SIDE cells a side
BIN_SIDE = 64


class BinTable(NamedTuple):
    """An xy grid over a translate-group loop's offsets and the members
    each cell lists (`bin_table`)."""

    origin: np.ndarray  # float32 (2,): the grid's lower corner X0, Y0
    cell: float  # the cells' side, a power of two
    shape: tuple  # (nx, ny) cells; cell (ix, iy) is number iy * nx + ix
    starts: np.ndarray  # (nx * ny + 1,): where each cell's list starts in ids
    ids: np.ndarray  # the members listed, ascending within each cell


def bin_table(xy, reach) -> BinTable:
    """The members of a translate-group loop that each cell of an xy grid
    can reach: member i is listed for a cell wherever its axis xy[i] comes
    within reach + m of the cell's closed rectangle, m = 2^-12 (1 + s),
    s the largest |coordinate| of an axis plus reach. The grid spans the
    axes grown by reach + 2m on each side, so a point outside it lies
    farther than reach from every axis.

    Why m covers the kernel's float32 arithmetic (this is float64): a point
    that the kernel puts in cell (ix, iy) has fl(px - X0) in [ix c, (ix + 1)
    c) (the product by 1 / c, c a power of two, is exact), so px lies
    within e = 2^-24 W of the cell, W the grid's width (< 2 s + 4 m); its
    computed distance from an axis, sqrtf(fl(qx*qx) + fl(qy*qy)) with
    qx = fl(px - ox), is at least its real one times 1 - 2^-22 (a square
    that underflows is below 2^-126 beside the other, >= 2^-25). So a
    member not listed lies at a computed distance >= (reach + m - 2e)(1 -
    2^-22) >= reach from every point put in the cell: m exceeds 2e +
    2^-22 (reach + m) over 500 times. A point put outside the grid is as
    far: fl(px - X0) < 0 only where px < X0, and fl(px - X0) >= nx c only
    where px > X0 + nx c - e."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    reach = float(reach)
    span = float(np.abs(xy).max(initial=0.0)) + reach
    m = 2.0 ** -12 * (1.0 + span)
    cell = 2.0 ** round(math.log2(max(reach, 2.0 ** -20)))
    lo, hi = xy.min(0) - reach - 2 * m, xy.max(0) + reach + 2 * m
    origin = lo.astype(np.float32)
    origin = np.where(origin > lo, np.nextafter(origin, np.float32(-np.inf)), origin)
    shape = np.ceil((hi - origin) / cell).astype(np.int64)
    while shape.max() > BIN_SIDE:
        cell *= 2
        shape = np.ceil((hi - origin) / cell).astype(np.int64)
    gaps = []
    for a in range(2):  # each axis's distance from each member to each cell's span
        edges = origin[a].astype(np.float64) + cell * np.arange(shape[a] + 1)
        x = xy[:, a, None]
        gaps.append(np.maximum(np.maximum(edges[None, :-1] - x, x - edges[None, 1:]), 0.0))
    near = np.hypot(gaps[0][:, None, :], gaps[1][:, :, None]) < reach + m  # (G, ny, nx)
    lists = [np.nonzero(near[:, iy, ix])[0] for iy in range(shape[1]) for ix in range(shape[0])]
    starts = np.concatenate([[0], np.cumsum([len(c) for c in lists])])
    ids = np.concatenate(lists + [np.zeros(0, np.int64)])
    return BinTable(origin, cell, (int(shape[0]), int(shape[1])), starts, ids)


#: floats of a parameter vector that the templates still take by value, as
#: a kernel parameter: with the kernels' other arguments it stays inside
#: the 4 KB of kernel parameters that every CUDA version allows
PARAMS_BY_VALUE_MAX = 1000


def tree_sites(tree: Shader) -> list:
    """The short-circuit sites of `tree`'s baked source, in GSDF_SITE
    order: (the Difference's function, its subtrahend's function, the
    subtrahend's lower bound)."""
    cg = Codegen()
    cg.emit(tree)
    return cg.sites


def tree_loops(tree: Shader) -> list:
    """The translate-group loops of `tree`'s baked threshold forms, in
    GSDF_LOOP order: (the loop's name, the member's function, the
    members)."""
    cg = Codegen()
    cg.emit(tree)
    return cg.loops


def tree_polygons(tree: Shader) -> list:
    """The polygons' edge loops of `tree`'s baked source, in GSDF_EDGES
    order: (the polygon's function, its edges)."""
    cg = Codegen()
    cg.emit(tree)
    return cg.polygons


def tree_source(tree: Shader, parametric: bool = False, by_value: bool | None = None) -> str:
    """Self-contained C++/CUDA source of `tree` ending in gsdf_tree().
    parametric=True gives the parametric form (see the module note), with
    the vector by value up to PARAMS_BY_VALUE_MAX floats unless `by_value`
    says otherwise."""
    cg = Codegen(parametric)
    root = cg.emit(tree)
    names = ("px", "py", "pz")[: tree.NDIM]
    args = ", ".join("float " + n for n in names)
    out = cg.source() + f"\n#undef GSDF_NDIM\n#define GSDF_NDIM {tree.NDIM}\n"
    if not parametric:
        return (
            out
            + f"GSDF_HD float gsdf_tree({args}) {{\n"
            + f"    return {root}({', '.join(names)});\n}}\n"
        )
    n = max(1, cg.slice_size(tree))
    if by_value is None:
        by_value = n <= PARAMS_BY_VALUE_MAX
    return (
        out
        + "#undef GSDF_PARAMETRIC\n#undef GSDF_NPARAMS\n#undef GSDF_PARAMS_BY_VALUE\n"
        + f"#define GSDF_PARAMETRIC 1\n#define GSDF_NPARAMS {n}\n"
        + f"#define GSDF_PARAMS_BY_VALUE {int(bool(by_value))}\n"
        + f"GSDF_HD float gsdf_tree(const float* P, {args}) {{\n"
        + f"    return {root}({', '.join(('P',) + names)});\n}}\n"
    )
