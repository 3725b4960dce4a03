"""Dual contouring's static tables (gsdf_tpu/render/dual_contour.py:166-176),
shared by the plain torch version (ops/dc_emit.py), the host quad emission
(render/dual_contour.py, native gsdf_dc_finish) and K5 (csrc/dc_mesh.cu,
through the header that `header()` generates).

- OFFS[a]: the four voxels around an edge of axis a, as (di, dj, dk)
  offsets from the edge's own voxel, in quad-corner order (reference
  dual_contour.go:277-293).
- OFF5[a]: OFFS[a] and the own voxel again: the reference adds an edge's
  row to its own voxel twice (dual_contour_vertexplacement.go:57-63).
- GATHER[a]: the same five contributions seen from the voxel that
  receives them, as the (di, dj, dk) offsets of the contributing edge's
  voxel, in the order in which the JAX package sums a voxel's rows. That
  order is its stable argsort of the contributions by voxel: by edge id
  (axis first, then the edge voxel's linear id) and then by the position
  c in OFF5. It depends on nothing but the axis, so a kernel can gather a
  voxel's rows in that order instead of sorting.
"""
from __future__ import annotations

OFFS = {
    0: [(0, -1, -1), (0, 0, -1), (0, 0, 0), (0, -1, 0)],
    1: [(-1, 0, -1), (-1, 0, 0), (0, 0, 0), (0, 0, -1)],
    2: [(-1, -1, 0), (0, -1, 0), (0, 0, 0), (-1, 0, 0)],
}
OFF5 = {a: OFFS[a] + [(0, 0, 0)] for a in OFFS}


def _gather(a):
    # the edge voxel is the receiving voxel minus the offset; its linear id
    # orders as (dk, dj, di), and equal edges keep the order of c
    order = sorted(range(5), key=lambda c: (tuple(-x for x in OFF5[a][c][::-1]), c))
    return [tuple(-x for x in OFF5[a][c]) for c in order]


GATHER = {a: _gather(a) for a in range(3)}


def header() -> str:
    """GATHER as a device table for K5 (csrc/dc_mesh.cu)."""
    rows = ", ".join(f"{{{a}, {di}, {dj}, {dk}}}"
                     for a in range(3) for di, dj, dk in GATHER[a])
    return (
        "// Generated by gsdf_tpu_torch/ops/dc_tables.py -- do not edit.\n"
        "#pragma once\n\n"
        "// A voxel's 15 contributions in summation order: edge axis, then the\n"
        "// (di, dj, dk) offset of the contributing edge's voxel from the voxel.\n"
        f"static __device__ constexpr int kDcGather[15][4] = {{{rows}}};\n"
    )
