"""The shared marching-cubes pieces (gsdf_tpu/ops/mc_emit.py): every
triangle path (fused soup, staged, welded) composes these.

Conventions shared with the JAX package and the host decoder:
- corner grid grid[k, j, i], z slowest;
- cube linear id = (ck*ny + cj)*nx + ci (x fastest, the reference's
  iteration order, flatrenderer.go:210-212, so triangle order matches);
- corner order and winding per marchcubes.go:222-233 / :63-68;
- corner-0 quick reject |d0| <= f32(2*sqrt3) * res in float32
  (marchcubes.go:23).

Two of the device stages are hand-written CUDA kernels (csrc/), each
beside its plain torch version: K3 `compact_active` (the active cubes'
ids, ascending, with K4's edge count and offsets) and K7s
`emit_triangles` (the soup). On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches its kernel
or raises. Sizes are exact, read from a device count: no padding, no
grow-and-retry.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import mathx as mx
from .mc_tables import (  # noqa: F401  (CORNER_OFFSETS .. LOW_EDGE_FAR re-exported)
    CORNER_OFFSETS,
    EDGE_AXIS,
    EDGE_LOW,
    LOW_EDGE_FAR,
    MC_EDGE_PAIRS,
    MC_TRI_COUNT,
    MC_TRI_TABLE,
)

_f32 = np.float32

# float32(2*sqrt3) with the reference's sqrt3 constant (glrender/glrender.go:9)
CUBE_DIAG_FACTOR = np.float32(2 * 1.73205080757)
MC_EPS = 1e-12
#: int32 cube ids: grids of this many cubes or more are sliced first
MAX_CUBES = 1 << 31


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


def cube_coords(ids, nx: int, ny: int):
    """(ci, cj, ck) int64 of int cube ids, x fastest."""
    ids = ids.to(torch.int64)
    return ids % nx, (ids // nx) % ny, ids // (nx * ny)


def gather_corners(grid_flat, base_lin, stride_j: int, stride_k: int):
    """The 8 corner values per cube (A,8); base_lin (A,) is each cube's
    corner-0 index in grid_flat, the strides its +j / +k steps."""
    offs = torch.from_numpy(CORNER_OFFSETS.astype(np.int64)).to(base_lin.device)
    gi = (
        base_lin[:, None]
        + offs[None, :, 2] * stride_k
        + offs[None, :, 1] * stride_j
        + offs[None, :, 0]
    )
    return grid_flat[gi]


def corner_positions(origin, res, fi, fj, fk):
    """Corner positions (A,8,3) from the float32 index coordinates of each
    cube's corner 0, in the reference's arithmetic (flatrenderer.go:
    235-247): origin + index*res, then + offset*res per corner."""
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))
    base = torch.stack(
        [float(o[0]) + fi * r, float(o[1]) + fj * r, float(o[2]) + fk * r], dim=-1
    )  # (A,3)
    offs = torch.from_numpy(CORNER_OFFSETS.astype(_f32)).to(base.device)
    return base[:, None, :] + offs[None, :, :] * r  # (A,8,3)


def edge_t(va, vb):
    """(t, ca, cb) on edges from va to vb, the epsilon rules of
    mcInterpolate (marchcubes.go:76-98): t = (0 - va) / (vb - va), or 0.5
    where both ends lie within 1e-12 of zero; ca / cb mark an end that
    does. Every path's interpolation goes through here (the CUDA kernels
    through csrc/gsdf_scan.cuh's mc_edge_t)."""
    eps = mx.const(MC_EPS, va)  # compared in float32, as the JAX package does
    ca = torch.abs(va) < eps
    cb = torch.abs(vb) < eps
    return torch.where(ca & cb, 0.5, (0.0 - va) / (vb - va)), ca, cb


def lerp_edges(va, vb, pa, pb):
    """Edge points pa + t * (pb - pa) (..., 3), snapped to the end that
    lies within 1e-12 of zero. va, vb (...) distances, pa, pb (..., 3)."""
    t, ca, cb = edge_t(va, vb)
    pt = pa + t[..., None] * (pb - pa)
    pt = torch.where((cb & ~ca)[..., None], pb, pt)
    return torch.where((ca & ~cb)[..., None], pa, pt)


def interpolate_edges(v, pc):
    """The 12 edge points per cube. v (A,8), pc (A,8,3) -> (A,12,3)."""
    pairs = torch.from_numpy(MC_EDGE_PAIRS.astype(np.int64)).to(v.device)
    return lerp_edges(v[:, pairs[:, 0]], v[:, pairs[:, 1]],
                      pc[:, pairs[:, 0], :], pc[:, pairs[:, 1], :])


def cube_bases(grid, ids):
    """Each cube's corner-0 index in the flat grid, and (ci, cj, ck)."""
    nk, nj, ni = grid.shape
    ci, cj, ck = cube_coords(ids, ni - 1, nj - 1)
    return (ck * nj + cj) * ni + ci, (ci, cj, ck)


def check_kernel_inputs(grid, cases, ids):
    """Check the inputs of an MC kernel; returns (device, A, nx, ny, nz)."""
    nk, nj, ni = grid.shape
    device = kernels.cuda_device(grid.device)
    kernels.check_out(grid, (nk, nj, ni), torch.float32, device)
    kernels.check_out(cases, (nk - 1, nj - 1, ni - 1), torch.uint8, device)
    kernels.check_out(ids, (ids.numel(),), torch.int32, device)
    return device, ids.numel(), ni - 1, nj - 1, nk - 1


# --- K3: order-preserving compaction ------------------------------------
#: active cubes per block of K4's emit kernel (csrc/compact_emit.cu)
EMIT_BLOCK = 256


class Compaction(NamedTuple):
    """K3's outputs: ids (A,) int32 of the active cubes, ascending; n_t
    the number of their crossing owner edges; offsets (ceil(A/256),) int64
    the crossing edges before every 256th active cube (K4's offsets)."""

    ids: torch.Tensor
    n_t: int
    offsets: torch.Tensor


def crossing(idx8):
    """(A,3) bool: which owner edges x, y, z cross, from the sign bits."""
    b0 = idx8 & 1
    return torch.stack(
        [b0 != ((idx8 >> 1) & 1), b0 != ((idx8 >> 3) & 1), b0 != ((idx8 >> 4) & 1)],
        dim=-1,
    )


def compact_indices_plain(cases):
    """The ids of K3's plain version: ascending int32 ids of the non-zero
    bytes."""
    return torch.nonzero(cases.reshape(-1)).squeeze(1).to(torch.int32)


def compact_active_plain(cases) -> Compaction:
    """K3's plain version."""
    ids = compact_indices_plain(cases)
    n_cross = crossing(cases.reshape(-1)[ids.to(torch.int64)]).sum(1)
    before = torch.cumsum(n_cross, 0) - n_cross
    return Compaction(ids, int(n_cross.sum()), before[::EMIT_BLOCK])


def compact_active(cases) -> Compaction:
    """Compaction of the non-zero case bytes of a u8 case grid (K3;
    gsdf_tpu/ops/mc_emit.py:190-288 without its padding): the ids, and
    K4's edge count and offsets. One launch and one read of the counts.

    The ids are the first A entries of a buffer of one int32 per cube."""
    n = cases.numel()
    if n >= MAX_CUBES:
        raise ValueError(
            f"compact_active: {n} cubes exceed int32 ids (2^31); slice the grid first"
        )
    if cases.device.type == "cpu":
        return compact_active_plain(cases)
    device = kernels.cuda_device(cases.device)
    kernels.check_out(cases, tuple(cases.shape), torch.uint8, device)
    if n == 0:
        return Compaction(torch.empty(0, dtype=torch.int32, device=device), 0,
                          torch.empty(0, dtype=torch.int64, device=device))
    lib = kernels.static_lib("compact_active")
    # one int64 buffer: counts (2), K4's offsets, the tiles' status words
    work = torch.empty(lib.gsdf_compact_work(n), dtype=torch.int64, device=device)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        kernels.check_rc("compact_active", lib.gsdf_compact_active(
            cases.data_ptr(), n, work.data_ptr(), ids.data_ptr(), kernels.stream(device)))
    kernels.LAUNCHES["compact_active"] += 1
    n_active, n_t = work[:2].tolist()  # the one read of the device counts
    return Compaction(ids[:n_active], n_t, work[2 : 2 + -(-n_active // EMIT_BLOCK)])


def compact_indices(cases):
    """Ascending int32 ids of the non-zero case bytes (K3's ids)."""
    return compact_active(cases).ids


# --- K7s: the triangle soup ---------------------------------------------
def emit_triangles_plain(grid, cases, ids, origin, res, k0=0):
    """K7s's plain version (the torch port of the JAX package's
    emit_triangles + corner_positions + interpolate_edges): (T,3,3) f32
    triangles of the cubes `ids`, cube-then-table order, reversed winding.
    k0 is added to the z index coordinate as a float32."""
    base, (ci, cj, ck) = cube_bases(grid, ids)
    nk, nj, ni = grid.shape
    v = gather_corners(grid.reshape(-1), base, ni, nj * ni)  # (A,8)
    fk = ck.to(torch.float32) + float(_f32(k0))
    pc = corner_positions(origin, res, ci.to(torch.float32), cj.to(torch.float32), fk)
    pt = interpolate_edges(v, pc)  # (A,12,3)
    idx8 = cases.reshape(-1)[ids.to(torch.int64)].to(torch.int64)
    table = torch.from_numpy(MC_TRI_TABLE.astype(np.int64)).to(grid.device)[idx8]
    counts = torch.from_numpy(MC_TRI_COUNT.astype(np.int64)).to(grid.device)[idx8]
    rows = torch.arange(len(ids), device=grid.device)[:, None, None]
    tris = pt[rows, table.clamp(min=0)].flip(2)  # (A,5,3,3), reference winding
    valid = torch.arange(5, device=grid.device)[None, :] < counts[:, None]
    return tris[valid]


def emit_triangles(grid, cases, ids, origin, res, k0=0):
    """Triangle soup (T,3,3) f32 of the active cubes `ids` (K7s;
    gsdf_tpu/ops/mc_emit.py:305-373). grid (nk,nj,ni) distances, cases
    its u8 case grid, k0 the grid's plane offset in the whole grid."""
    if grid.device.type == "cpu":
        return emit_triangles_plain(grid, cases, ids, origin, res, k0)
    device, A, nx, ny, _ = check_kernel_inputs(grid, cases, ids)
    if A == 0:
        return torch.empty((0, 3, 3), dtype=torch.float32, device=device)
    lib = kernels.static_lib("emit_soup")
    offsets = torch.empty(lib.gsdf_emit_soup_blocks(A), dtype=torch.int64, device=device)
    total = torch.empty(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        s = kernels.stream(device)
        kernels.check_rc("emit_soup", lib.gsdf_emit_soup_count(
            cases.data_ptr(), ids.data_ptr(), A, offsets.data_ptr(), total.data_ptr(), s))
        tris = torch.empty((int(total.item()), 3, 3), dtype=torch.float32, device=device)
        kernels.check_rc("emit_soup", lib.gsdf_emit_soup(
            grid.data_ptr(), cases.data_ptr(), ids.data_ptr(), A, nx, ny,
            *kernels.float_args(origin, res, k0), offsets.data_ptr(), tris.data_ptr(), s))
    kernels.LAUNCHES["emit_soup"] += 1
    return tris


def dense_grid_mc(grid, cases, origin, res, k0=0):
    """Marching cubes over a device-resident corner grid and its case
    grid: compact (K3), then emit (K7s). Returns tris (T,3,3) on the
    grid's device."""
    return emit_triangles(grid, cases, compact_indices(cases), origin, res, k0)
