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
skips). A tree with no Difference over a bounded subtrahend, and every
parametric source, has no site and no such lines.

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
  they read. `eval/parametric.py::kernel_index` lays a tree's vector out
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

import numpy as np

from ..core.mathx import CBRT_MAGIC, CBRT_STEPS, COS_ACOS_3_COEFFS
from ..core.node import Shader

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
        #: the short-circuit sites, in their GSDF_SITE order: (the
        #: Difference's function, its subtrahend's function, the bound)
        self.sites: list = []

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

    def array(self, node: Shader, values) -> str:
        """Emit a float32 constant table for `node`; returns its name."""
        fn = self.name(node)
        i = self._n_arrays.get(fn, 0)
        self._n_arrays[fn] = i + 1
        name = f"{fn}_c{i}"
        flat = np.asarray(values, np.float32).reshape(-1)
        body = ",\n    ".join(
            ", ".join(lit(v) for v in flat[r : r + 4]) for r in range(0, len(flat), 4)
        )
        self._chunks.append(f"GSDF_CONST float {name}[{len(flat)}] = {{\n    {body}\n}};")
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

    def short_circuit(self, node: Shader, sub: Shader, args) -> str:
        """The line of a Difference `node`'s body, after its minuend's value
        `a`, that returns `a` where its subtrahend `sub` cannot change the
        result: baked mode and a finite `sub.lower_bound()` (the module
        note); else "". `args` are the function's coordinates."""
        if self.parametric:
            return ""
        lo = np.float32(sub.lower_bound())
        if not np.isfinite(lo):
            return ""
        k = len(self.sites)
        self.sites.append((self.name(node), self.emit(sub), lo))
        ordered = f"!isnan({' + '.join(args)})"
        return f"if (GSDF_SITE({k}, a > {lit(-lo)} && {ordered})) return a;\n"

    def emit(self, node: Shader) -> str:
        key = self._key(node)
        name = self._names.get(key)
        if name is not None:
            return name
        name = self.name(node)
        self._stack.append(node)
        try:
            body = node.emit_cuda(self)  # emits children and arrays first
        finally:
            self._stack.pop()
        params = ("float px", "float py", "float pz")[: node.NDIM]
        if self.parametric:
            params = ("const float* P",) + params
        indented = "\n".join("    " + ln for ln in body.splitlines())
        self._chunks.append(f"GSDF_HD float {name}({', '.join(params)}) {{\n{indented}\n}}")
        self._names[key] = name
        return name

    def source(self) -> str:
        sites = ""
        if self.sites:
            sites = (
                f"#undef GSDF_NSITES\n#define GSDF_NSITES {len(self.sites)}\n"
                "#ifndef GSDF_SITE\n#define GSDF_SITE(k, skip) (skip)\n#endif\n"
            )
        return PRELUDE + sites + "\n" + "\n\n".join(self._chunks) + "\n"


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
