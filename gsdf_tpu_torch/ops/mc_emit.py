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
ids, ascending, with the counts and block offsets of what K4, K7s and K7w
emit for them) and K7s `emit_triangles` (the soup). On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches its kernel
or raises. Sizes are exact, from K3's one read of its device counts: no
padding, no grow-and-retry, no count pass in an emit kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, spans
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
#: active cubes per block of the emit kernels K4, K7s and K7w (csrc/)
EMIT_BLOCK = 256
#: cubes per entry of K3's edge_ranks directory (csrc/gsdf_scan.cuh)
RANK_CHUNK = 32


class Compaction(NamedTuple):
    """K3's outputs. ids (A,) int32 of the active cubes, ascending. n_t
    their crossing owner edges (K4's t values, K7w's vertices) and n_tris
    their triangles (MC_TRI_COUNT[case]); offsets and tri_offsets
    (ceil(A/256),) int64 the same two sums before every 256th active cube,
    where a block of an emit kernel starts. edge_ranks, only where asked
    for: (ceil(cubes/32) + 1,) int32, the crossing owner edges before every
    32nd cube of the grid and, last, their total (K7w's owner lookup),
    else None."""

    ids: torch.Tensor
    n_t: int
    offsets: torch.Tensor
    n_tris: int
    tri_offsets: torch.Tensor
    edge_ranks: torch.Tensor | None = None


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


def _before(counts):
    """Exclusive running sum of int64 counts."""
    return torch.cumsum(counts, 0) - counts


def compact_active_plain(cases, edge_ranks: bool = False) -> Compaction:
    """K3's plain version."""
    flat = cases.reshape(-1)
    ids = compact_indices_plain(cases)
    idx8 = flat[ids.to(torch.int64)]
    n_cross = crossing(idx8).sum(1)
    n_tri = torch.from_numpy(MC_TRI_COUNT.astype(np.int64)).to(cases.device)[idx8.to(torch.int64)]
    ranks = None
    if edge_ranks:  # over every cube of the grid: an inactive one (case 0) has no edge
        dense = crossing(flat).sum(1)
        ranks = torch.cat([_before(dense)[::RANK_CHUNK], dense.sum()[None]]).to(torch.int32)
    return Compaction(ids, int(n_cross.sum()), _before(n_cross)[::EMIT_BLOCK],
                      int(n_tri.sum()), _before(n_tri)[::EMIT_BLOCK], ranks)


def compact_active(cases, edge_ranks: bool = False) -> Compaction:
    """Compaction of the non-zero case bytes of a u8 case grid (K3;
    gsdf_tpu/ops/mc_emit.py:190-288 without its padding): the ids, and the
    counts and block offsets of the edges and triangles that K4, K7s and
    K7w emit for them. One launch and one read of the counts, the only
    read of a render before its fetch. edge_ranks=True also fills the
    directory that K7w's owner lookup needs.

    The ids are the first A entries of a buffer of one int32 per cube."""
    n = cases.numel()
    if n >= MAX_CUBES:
        raise ValueError(
            f"compact_active: {n} cubes exceed int32 ids (2^31); slice the grid first"
        )
    if cases.device.type == "cpu":
        return compact_active_plain(cases, edge_ranks)
    device = kernels.cuda_device(cases.device)
    kernels.check_out(cases, tuple(cases.shape), torch.uint8, device)
    ranks = None
    if edge_ranks:
        ranks = torch.empty(-(-n // RANK_CHUNK) + 1, dtype=torch.int32, device=device)
    if n == 0:
        none = torch.empty(0, dtype=torch.int64, device=device)
        return Compaction(torch.empty(0, dtype=torch.int32, device=device), 0, none, 0, none,
                          None if ranks is None else ranks.zero_())
    lib = kernels.static_lib("compact_active")
    # one int64 buffer: counts (4), both offsets, the tiles' status words
    work = torch.empty(lib.gsdf_compact_work(n), dtype=torch.int64, device=device)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    lib.launch("compact_active", device, cases.data_ptr(), n, work.data_ptr(), ids.data_ptr(),
               None if ranks is None else ranks.data_ptr())
    with spans.span("mc.count_read"):
        n_active, n_t, n_tris = work[:3].tolist()  # the one read of the device counts
    blocks, stride = -(-n_active // EMIT_BLOCK), n // EMIT_BLOCK + 1
    return Compaction(ids[:n_active], n_t, work[4 : 4 + blocks],
                      n_tris, work[4 + stride : 4 + stride + blocks],
                      ranks)


def compact_indices(cases):
    """Ascending int32 ids of the non-zero case bytes (K3's ids)."""
    return compact_active(cases).ids


# --- K7s: the triangle soup ---------------------------------------------
def atlas_global_coords(ci, cj, ck, tiles, S: int):
    """(gi, gj, gk) int64 global cube coordinates of cubes (ci, cj, ck)
    of a tile atlas (eval/grid_kernels.py::tile_grid; atlas plane ck is
    tile ck // (S+1), local plane ck % (S+1)); tiles (T, 3) [i, j, k]."""
    tiles = tiles.to(device=ci.device, dtype=torch.int64)
    t, lk = ck // (S + 1), ck % (S + 1)
    return tiles[t, 0] * S + ci, tiles[t, 1] * S + cj, tiles[t, 2] * S + lk


def emit_triangles_plain(grid, cases, ids, origin, res, k0=0, tiles=None):
    """K7s's plain version (the torch port of the JAX package's
    emit_triangles + corner_positions + interpolate_edges): (T,3,3) f32
    triangles of the cubes `ids`, cube-then-table order, reversed winding.
    k0 is added to the z index coordinate as a float32. With `tiles` the
    grid is a tile atlas and positions come from global indices (tile
    mode, gsdf_tpu/render/pruned.py:175-189)."""
    base, (ci, cj, ck) = cube_bases(grid, ids)
    nk, nj, ni = grid.shape
    v = gather_corners(grid.reshape(-1), base, ni, nj * ni)  # (A,8)
    if tiles is not None:
        ci, cj, ck = atlas_global_coords(ci, cj, ck, tiles, ni - 1)
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


def block_offsets(name, cases, ids, count, offsets, edge_ranks=False):
    """K3's Compaction for an emit wrapper that was not handed K3's count
    and block offsets for `ids`: runs K3 on `cases` (the emit kernels have
    no count pass of their own). None where both were given."""
    if count is not None and offsets is not None:
        return None
    comp = compact_active(cases, edge_ranks)
    if len(comp.ids) != len(ids):
        raise ValueError(f"{name}: {len(ids)} ids, but the case grid has {len(comp.ids)} active")
    return comp


def emit_triangles(grid, cases, ids, origin, res, k0=0, n_tris=None, tri_offsets=None,
                   tiles=None):
    """Triangle soup (T,3,3) f32 of the active cubes `ids` (K7s;
    gsdf_tpu/ops/mc_emit.py:305-373). grid (nk,nj,ni) distances, cases
    its u8 case grid, k0 the grid's plane offset in the whole grid.
    n_tris and tri_offsets are K3's triangle count and block offsets for
    these ids: with them the call is one launch and reads nothing; without
    them the wrapper runs K3 on `cases` first.

    Tile mode: `tiles` (T, 3) int32 makes grid and cases a tile atlas of
    S = ni - 1 (eval/grid_kernels.py::tile_grid, k0 0) and places each
    cube by its global index (gsdf_tpu/render/pruned.py:175-189)."""
    if tiles is not None and (tuple(tiles.shape) != (grid.shape[0] // grid.shape[2], 3)
                              or grid.shape[0] % grid.shape[2]
                              or grid.shape[1] != grid.shape[2] or int(k0) != 0):
        raise ValueError(f"tile mode needs a (T*P, P, P) atlas of (T, 3) tiles and k0 0, got "
                         f"{tuple(grid.shape)}, {tuple(tiles.shape)} tiles, k0 {k0}")
    if grid.device.type == "cpu":
        return emit_triangles_plain(grid, cases, ids, origin, res, k0, tiles)
    device, A, nx, ny, _ = check_kernel_inputs(grid, cases, ids)
    if tiles is not None:
        kernels.check_out(tiles, tuple(tiles.shape), torch.int32, device)
    comp = block_offsets("emit_triangles", cases, ids, n_tris, tri_offsets)
    if comp is not None:
        n_tris, tri_offsets = comp.n_tris, comp.tri_offsets
    tris = torch.empty((int(n_tris), 3, 3), dtype=torch.float32, device=device)
    if A == 0:
        return tris
    kernels.check_out(tri_offsets, (-(-A // EMIT_BLOCK),), torch.int64, device)
    lib = kernels.static_lib("emit_soup")
    lib.launch("emit_soup", device, grid.data_ptr(), cases.data_ptr(), ids.data_ptr(), A, nx, ny,
               *kernels.float_args(origin, res, k0), None if tiles is None else tiles.data_ptr(),
               tri_offsets.data_ptr(), tris.data_ptr())
    return tris


def dense_grid_mc(grid, cases, origin, res, k0=0):
    """Marching cubes over a device-resident corner grid and its case
    grid: compact (K3, the one count read), then emit (K7s). Returns tris
    (T,3,3) on the grid's device."""
    comp = compact_active(cases)
    return emit_triangles(grid, cases, comp.ids, origin, res, k0, comp.n_tris, comp.tri_offsets)
