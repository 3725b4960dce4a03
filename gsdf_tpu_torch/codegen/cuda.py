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

`tree_source(tree)` ends with the root function the kernel templates call,
`gsdf_tree(px, py, pz)` for a 3D tree and `gsdf_tree(px, py)` for a 2D one,
and defines GSDF_NDIM (3 or 2) so that a template can tell which it got.
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
    """Collects the functions and constant arrays of one tree."""

    def __init__(self):
        self._names: dict = {}  # tree hash -> function name
        self._chunks: list = []  # emitted arrays and functions, in order
        self._n_arrays: dict = {}  # function name -> arrays emitted

    @staticmethod
    def lit(x) -> str:
        return lit(x)

    @staticmethod
    def name(node: Shader) -> str:
        return f"{type(node).__name__.lower()}_{node.tree_hash().hex()[:12]}"

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
        """A call of `node`'s function on `args`, emitting it on first use."""
        return f"{self.emit(node)}({', '.join(args)})"

    def emit(self, node: Shader) -> str:
        key = node.tree_hash()
        name = self._names.get(key)
        if name is not None:
            return name
        name = self.name(node)
        body = node.emit_cuda(self)  # emits children and arrays first
        params = ("float px", "float py", "float pz")[: node.NDIM]
        indented = "\n".join("    " + ln for ln in body.splitlines())
        self._chunks.append(f"GSDF_HD float {name}({', '.join(params)}) {{\n{indented}\n}}")
        self._names[key] = name
        return name

    def source(self) -> str:
        return PRELUDE + "\n" + "\n\n".join(self._chunks) + "\n"


def tree_source(tree: Shader) -> str:
    """Self-contained C++/CUDA source of `tree` ending in gsdf_tree()."""
    cg = Codegen()
    root = cg.emit(tree)
    names = ("px", "py", "pz")[: tree.NDIM]
    return (
        cg.source()
        + f"\n#undef GSDF_NDIM\n#define GSDF_NDIM {tree.NDIM}\n"
        + f"GSDF_HD float gsdf_tree({', '.join('float ' + n for n in names)}) {{\n"
        + f"    return {root}({', '.join(names)});\n}}\n"
    )
