"""Marching-cubes classification (gsdf_tpu/ops/mc_emit.py), plain torch.

Conventions shared with the JAX package and the host decoder:
- corner grid grid[k, j, i], z slowest;
- cube linear id = (ck*ny + cj)*nx + ci (x fastest, the reference's
  iteration order, flatrenderer.go:210-212);
- corner order per marchcubes.go:222-233;
- corner-0 quick reject |d0| <= f32(2*sqrt3) * res in float32
  (marchcubes.go:23).
"""
from __future__ import annotations

import numpy as np
import torch

from . import mc_tables
from ..core import mathx as mx

_f32 = np.float32

# float32(2*sqrt3) with the reference's sqrt3 constant (glrender/glrender.go:9)
CUBE_DIAG_FACTOR = np.float32(2 * 1.73205080757)
MC_EPS = 1e-12

# corner offsets (dx,dy,dz) in the reference's corner order
CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int32,
)

# per cube-edge e: axis and low-corner offset; the owner cube of edge e of
# cube c is c + low_offset, where it is the low edge `axis`
EDGE_AXIS = []
EDGE_LOW = []
for _a, _b in mc_tables.MC_EDGE_PAIRS:
    _oa = CORNER_OFFSETS[_a]
    _ob = CORNER_OFFSETS[_b]
    EDGE_AXIS.append(int(np.argmax(_oa != _ob)))
    EDGE_LOW.append(np.minimum(_oa, _ob))
EDGE_AXIS = np.array(EDGE_AXIS, np.int32)  # (12,)
EDGE_LOW = np.array(EDGE_LOW, np.int32)  # (12,3)


def quick_reject_threshold(res) -> np.float32:
    """f32(2*sqrt3) * res, rounded in float32 as the JAX package does."""
    return CUBE_DIAG_FACTOR * _f32(res)


def cube_corner_views(grid):
    """The 8 per-cube corner arrays of a dense (nk,nj,ni) grid."""
    return (
        grid[:-1, :-1, :-1],  # 0: (0,0,0)
        grid[:-1, :-1, 1:],  # 1: (+x,0,0)
        grid[:-1, 1:, 1:],  # 2: (+x,+y,0)
        grid[:-1, 1:, :-1],  # 3: (0,+y,0)
        grid[1:, :-1, :-1],  # 4: (0,0,+z)
        grid[1:, :-1, 1:],  # 5: (+x,0,+z)
        grid[1:, 1:, 1:],  # 6: (+x,+y,+z)
        grid[1:, 1:, :-1],  # 7: (0,+y,+z)
    )


def case_index(corners):
    """256-case MC index from the 8 corner arrays (sign bit per corner;
    -0.0 is not negative)."""
    index = torch.zeros(corners[0].shape, dtype=torch.int32, device=corners[0].device)
    for b, v in enumerate(corners):
        index = index | ((v < 0.0).to(torch.int32) << b)
    return index


def classify(grid, res):
    """Dense classification: (case index int32, active mask).

    active = corner-0 quick reject AND mixed signs (index not 0/255, the
    exact set of cases with a non-empty triangle table)."""
    corners = cube_corner_views(grid)
    index = case_index(corners)
    keep = torch.abs(corners[0]) <= mx.lit(quick_reject_threshold(res))
    active = keep & (index != 0) & (index != 255)
    return index, active


def effective_cases(grid, res):
    """The classified-grid kernel's output: u8 case where active, else 0."""
    index, active = classify(grid, res)
    return torch.where(active, index, 0).to(torch.uint8)
