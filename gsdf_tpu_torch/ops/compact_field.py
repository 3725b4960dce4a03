"""Compact-field render (gsdf_tpu/ops/compact_field.py), the main path.

From the classified grid (K1), the device keeps only what the host
decoder needs: the ascending ids of the active cubes (K3), their case
bytes, and the interpolation parameter t of every crossing owner edge,
compacted cube-major with axes x, y, z (K4). The host walks the MC tables
(native.mc_decode), as the reference does (glrender/octreerenderer.go:131
-> marchcubes.go:34).

The JAX package packs ids as u8 deltas for its slow device link
(compact_field.py:22-30, :91-147); the port fetches ids (u32), cases (u8)
and t (f32) as they are, with identical decoded arrays. Sizes come from
one read of K3's device counts, so there is no grow-and-retry and no size
hint.

The pruned renderer's counterpart (render/pruned.py) runs the same K3 and
K4 over a tile atlas (eval/grid_kernels.py::tile_grid, K6a), which they
read as an ordinary grid, with one more kernel that maps the atlas cube
ids to global ones (`tile_global_ids`): `tile_compact_emit` per batch of
tiles, then `merge_compact_payloads` on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels, spans
from ..eval.grid_kernels import classified_grid
from .mc_emit import (  # noqa: F401  (crossing re-exported)
    EMIT_BLOCK,
    MAX_CUBES,
    atlas_global_coords,
    block_offsets,
    check_kernel_inputs,
    compact_active,
    compact_active_plain,
    crossing,
    cube_bases,
    cube_coords,
    edge_t,
)

_f32 = np.float32


def _owner_edge_t(v0, vfar):
    """t on the 3 low (owner) edges of each cube, with the reference's
    epsilon snaps baked in (0, 1 or 0.5). v0 (A,1), vfar (A,3) -> (A,3)."""
    t, ca, cb = edge_t(v0, vfar)
    t = torch.where(cb & ~ca, 1.0, t)
    t = torch.where(ca & ~cb, 0.0, t)
    return t


# --- K4: the compact emit -----------------------------------------------
def compact_emit_plain(grid, cases, ids):
    """K4's plain version: (case bytes (A,) u8, t (V,) f32)."""
    nk, nj, ni = grid.shape
    base, _ = cube_bases(grid, ids)
    idx8 = cases.reshape(-1)[ids.to(torch.int64)]
    strides = torch.tensor([0, 1, ni, nj * ni], dtype=torch.int64, device=grid.device)
    v4 = grid.reshape(-1)[base[:, None] + strides[None, :]]  # (A,4): v0,vx,vy,vz
    t = _owner_edge_t(v4[:, 0:1], v4[:, 1:])
    return idx8, t[crossing(idx8)]  # boolean mask: cube-major, x,y,z


def compact_emit(grid, cases, ids, n_t=None, offsets=None):
    """grid (nk,nj,ni) corner distances, cases (nk-1,nj-1,ni-1) u8
    effective cases, ids the active cubes (K3) -> (case bytes u8, t f32)
    (K4; gsdf_tpu/ops/compact_field.py:217-261). n_t and offsets are K3's
    edge count and offsets for these ids; without them the wrapper runs K3
    on `cases` for them (K4 has no count pass of its own)."""
    if grid.device.type == "cpu":
        return compact_emit_plain(grid, cases, ids)
    device, A, nx, ny, _ = check_kernel_inputs(grid, cases, ids)
    comp = block_offsets("compact_emit", cases, ids, n_t, offsets)
    if comp is not None:
        n_t, offsets = comp.n_t, comp.offsets
    if A == 0:
        return (
            torch.empty(0, dtype=torch.uint8, device=device),
            torch.empty(0, dtype=torch.float32, device=device),
        )
    kernels.check_out(offsets, (-(-A // EMIT_BLOCK),), torch.int64, device)
    lib = kernels.static_lib("compact_emit")
    idx8 = torch.empty(A, dtype=torch.uint8, device=device)
    tvals = torch.empty(int(n_t), dtype=torch.float32, device=device)
    lib.launch("compact_emit", device, grid.data_ptr(), cases.data_ptr(), ids.data_ptr(), A, nx,
               ny, offsets.data_ptr(), idx8.data_ptr(), tvals.data_ptr())
    return idx8, tvals


def compact_field_render(tree, origin, res, shape, device, k0: int = 0,
                         parametric: bool = False):
    """Classify on the device (K1), compact (K3), emit (K4), fetch.
    Returns (ids (A,) u32, cases (A,) u8, tvals (V,) f32) as numpy arrays
    for native.mc_decode. k0 offsets the grid's z index (slab dispatch):
    the ids are local to the slab. parametric=True classifies through the
    library of the tree's structure (K1p): an edited tree needs no build."""
    nk, nj, ni = (int(x) for x in shape)
    if (nk - 1) * (nj - 1) * (ni - 1) >= MAX_CUBES:
        raise ValueError("grid too large for int32 cube ids")
    dist, cases = classified_grid(tree, origin, res, (nk, nj, ni), device, k0, parametric)
    comp = compact_active(cases)  # the one count read before the fetch
    ids = comp.ids
    idx8, tvals = compact_emit(dist, cases, ids, comp.n_t, comp.offsets)
    with spans.span("compact.fetch"):
        return ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(), tvals.cpu().numpy()


def compact_field_render_slabbed(tree, origin, res, shape, device, max_points,
                                 parametric: bool = False):
    """Compact-field render past the single-dispatch memory gate: one
    dispatch per z-slab of at most `max_points` corners (k0 offsets, one
    plane shared with the next slab); the slab payloads concatenate into
    exactly the whole-grid payload (gsdf_tpu/ops/compact_field.py:556-632).

    Returns (ids (A,) u32 GLOBAL cube ids, cases, tvals, corners
    evaluated)."""
    nk, nj, ni = (int(x) for x in shape)
    nx, ny, nz = ni - 1, nj - 1, nk - 1
    if nx * ny * nz >= MAX_CUBES:
        raise ValueError("grid too large for int32 cube ids")
    plane = nj * ni
    n_slabs = max(1, -(-nk * plane // max(1, int(max_points))))
    bounds_k = [nz * s // n_slabs for s in range(n_slabs + 1)]
    n_points = 0
    ids_parts, case_parts, t_parts = [], [], []
    for k0, k1 in zip(bounds_k[:-1], bounds_k[1:]):
        if k1 == k0:
            continue  # more slabs than cube layers (tiny test gates)
        slab_shape = (k1 - k0 + 1, nj, ni)
        n_points += slab_shape[0] * plane
        ids, cases, tvals = compact_field_render(
            tree, origin, res, slab_shape, device, k0, parametric
        )
        ids_parts.append(ids + np.uint32(k0 * nx * ny))
        case_parts.append(cases)
        t_parts.append(tvals)
    return (
        np.concatenate(ids_parts) if ids_parts else np.empty(0, np.uint32),
        np.concatenate(case_parts) if case_parts else np.empty(0, np.uint8),
        np.concatenate(t_parts) if t_parts else np.empty(0, _f32),
        n_points,
    )


# --- the pruned renderer: the tile atlas's payload ----------------------
def tile_global_ids_plain(ids, tiles, S, dims):
    """The id map's plain version: global int32 cube ids of atlas ids."""
    nx, ny, _ = (int(d) for d in dims)
    gi, gj, gk = atlas_global_coords(*cube_coords(ids, int(S), int(S)), tiles, int(S))
    return ((gk * ny + gj) * nx + gi).to(torch.int32)


def tile_global_ids(ids, tiles, S, dims):
    """The global cube ids (in the (nz, ny, nx) grid of dims = (nx, ny,
    nz)) of K3's atlas ids `ids` (A,) int32, tiles (T, 3) int32 the atlas's
    tile table of S^3-cube tiles (gsdf_tpu/ops/compact_field.py:311-319).
    The caller keeps the grid below 2^31 cubes."""
    if ids.device.type == "cpu":
        return tile_global_ids_plain(ids, tiles, S, dims)
    device = kernels.cuda_device(ids.device)
    A = ids.numel()
    nx, ny, _ = (int(d) for d in dims)
    kernels.check_out(ids, (A,), torch.int32, device)
    kernels.check_out(tiles, (tiles.shape[0], 3), torch.int32, device)
    out = torch.empty(A, dtype=torch.int32, device=device)
    if A == 0:
        return out
    lib = kernels.static_lib("tile_global_ids")
    lib.launch("tile_global_ids", device, ids.data_ptr(), A, tiles.data_ptr(), int(S), nx, ny,
               out.data_ptr())
    return out


def tile_compact_emit_plain(grid, cases, tiles, dims):
    """tile_compact_emit's plain version."""
    ids = compact_active_plain(cases).ids
    idx8, t = compact_emit_plain(grid, cases, ids)
    return tile_global_ids_plain(ids, tiles, grid.shape[2] - 1, dims), idx8, t


def tile_compact_emit(grid, cases, tiles, dims):
    """The compact payload of one batch of tiles: grid, cases the tile
    atlas of K6a (eval/grid_kernels.py::tile_grid), tiles its (T, 3) int32
    tile table, dims (nx, ny, nz) the whole grid's cubes -> (global cube
    ids (A,) int32, case bytes (A,) u8, t (V,) f32) on the atlas's device
    (gsdf_tpu/ops/compact_field.py::tile_compact_emit, :264-327, whose
    classification is K6a's). K3 compacts the atlas (its one count read),
    the id map makes the ids global, K4 emits case bytes and t. Rows are in
    the JAX package's tile-major slot order; merge_compact_payloads sorts
    the batches into the dense payload."""
    if grid.device.type == "cpu":
        return tile_compact_emit_plain(grid, cases, tiles, dims)
    comp = compact_active(cases)
    ids = tile_global_ids(comp.ids, tiles, grid.shape[2] - 1, dims)
    idx8, t = compact_emit(grid, cases, comp.ids, comp.n_t, comp.offsets)
    return ids, idx8, t


def merge_compact_payloads(parts):
    """Merge per-batch compact payloads (GLOBAL ids, batch-local t order)
    into the dense path's exact payload: ids ascending (= dense cube
    order), cases aligned, t re-gathered cube-major. Host numpy, O(A); the
    JAX package's merge (gsdf_tpu/ops/compact_field.py:330-380), copied.

    parts: list of (ids u32, cases u8, tvals f32). Returns
    (ids, cases, tvals)."""
    # a kept tile can hold no active cube (the prune keeps NEAR-surface
    # tiles): empty parts carry no rows and would break the per-part
    # rebase below
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return np.empty(0, np.uint32), np.empty(0, np.uint8), np.empty(0, _f32)
    ids = np.concatenate([p[0] for p in parts])
    cases = np.concatenate([p[1] for p in parts])
    tcat = np.concatenate([p[2] for p in parts])

    # crossing-edge count per cube from the case byte (K4's crossing rule)
    b0 = cases & 1
    cnt = (
        (b0 != ((cases >> 1) & 1)).astype(np.int64)
        + (b0 != ((cases >> 3) & 1))
        + (b0 != ((cases >> 4) & 1))
    )
    # each cube's t-slice start within tcat: per-part cumsum, offset by
    # the part's start in the concatenation
    ends = np.cumsum(cnt)
    starts = ends - cnt
    sizes = np.array([len(p[0]) for p in parts])
    tsizes = np.array([len(p[2]) for p in parts])
    part_row0 = np.cumsum(sizes) - sizes  # first row of each part
    part_t0 = np.cumsum(tsizes) - tsizes  # first t of each part
    row_part = np.repeat(np.arange(len(parts)), sizes)
    starts = starts - starts[part_row0][row_part] + part_t0[row_part]

    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    cases = cases[order]
    cnt_s = cnt[order]
    src = starts[order]
    out_end = np.cumsum(cnt_s)
    out_off = out_end - cnt_s
    total = int(out_end[-1])
    flat_src = np.repeat(src - out_off, cnt_s) + np.arange(total)
    return ids, cases, tcat[flat_src].astype(_f32, copy=False)
