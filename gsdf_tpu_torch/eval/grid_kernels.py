"""Dense grid evaluation on the card: the port of the JAX package's two
Pallas TPU kernels (gsdf_tpu/eval/pallas_grid.py).

- K2 `evaluate_grid`: distances at every corner of an (nk, nj, ni) grid,
  positions synthesised in-kernel (pallas_grid_eval_fn, :108-170).
- K1 `classified_grid`: the same evaluation and the marching-cubes
  classification, the first stage of every FlatRenderer path
  (pallas_classified_grid_fn, :187-346); one wrapper call launches its
  eval pass and its classify pass.

Both are hand-written CUDA C++ templates (gsdf_tpu_torch/csrc/) around
the per-tree distance function that codegen/cuda.py generates, one
library per tree ("grid" of kernels.LIBRARIES), which kernels.py builds
at first use. On a CPU tensor device each wrapper runs its plain torch
version; on a CUDA device it launches the kernel or raises.

K1 has a parametric form (`parametric=True`): the same template around
the tree's parametric source, one library per tree STRUCTURE ("classified"),
the tree's continuous parameters a launch argument (kernels.py).

The pruned renderer's two per-tree kernels (render/pruned.py) live here
too, baked and parametric, in one library per tree ("prune"):
- K6c `coarse_keep`: the keep mask of the coarse tile grid, the tree's
  distance at each tile centre against S*res*sqrt(3)/2
  (gsdf_tpu/render/pruned.py::_coarse_fn, :41-98);
- K6a `tile_grid`: the corners of T kept tiles as one atlas grid and its
  case grid (pruned.py::_tile_grid, :101-142, with the classification of
  ops/compact_field.py::tile_compact_emit, :288-303).

Grid layout is [k, j, i], x contiguous; the corner at integer index
(i, j, k) sits at origin + index * res in float32, from the global index.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build, check_out, cuda_device, float_args
from ..ops import mc_emit

_f32 = np.float32


def _shape(shape):
    nk, nj, ni = (int(x) for x in shape)
    if min(nk, nj, ni) < 1:
        raise ValueError(f"empty grid shape {shape}")
    return nk, nj, ni


# --- plain torch versions ------------------------------------------------
def grid_positions(origin, res, shape, device, k0: int = 0) -> torch.Tensor:
    """(nk, nj, ni, 3) float32 corner positions origin + index * res, from
    the global integer index (k offset by the slab's k0)."""
    nk, nj, ni = _shape(shape)
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))

    def axis(n, off, origin_c):
        idx = torch.arange(off, off + n, dtype=torch.int32, device=device)
        return float(origin_c) + idx.to(torch.float32) * r

    z = axis(nk, int(k0), o[2])[:, None, None].expand(nk, nj, ni)
    y = axis(nj, 0, o[1])[None, :, None].expand(nk, nj, ni)
    x = axis(ni, 0, o[0])[None, None, :].expand(nk, nj, ni)
    return torch.stack([x, y, z], dim=-1)


def evaluate_grid_plain(tree, origin, res, shape, device, k0: int = 0):
    """K2's plain version: the torch node tree on synthesised positions."""
    return tree.distance(grid_positions(origin, res, shape, device, k0))


def classified_grid_plain(tree, origin, res, shape, device, k0: int = 0):
    """K1's plain version: (dist (nk,nj,ni) f32, cases (nk-1,nj-1,ni-1) u8)."""
    dist = evaluate_grid_plain(tree, origin, res, shape, device, k0)
    return dist, mc_emit.effective_cases(dist, res)


# --- kernel wrappers -------------------------------------------------------
def evaluate_grid(tree, origin, res, shape, device, k0: int = 0):
    """Distances (nk, nj, ni) f32 at every grid corner (K2)."""
    nk, nj, ni = _shape(shape)
    if torch.device(device).type == "cpu":
        return evaluate_grid_plain(tree, origin, res, shape, device, k0)
    device = cuda_device(device)
    lib = build(tree)
    out = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    check_out(out, (nk, nj, ni), torch.float32, device)
    lib.launch("grid_eval", device, out.data_ptr(), *float_args(origin, res), int(k0), nk, nj,
               ni)
    return out


def classified_grid(tree, origin, res, shape, device, k0: int = 0, parametric: bool = False):
    """Eval + classify (K1): (dist (nk,nj,ni) f32, cases
    (nk-1,nj-1,ni-1) u8), the case 0 where the cube is inactive. k0 is the
    slab's first plane in the whole grid. parametric=True runs the
    parametric form (K1p): the library of the tree's structure, with the
    tree's current continuous parameters as a launch argument."""
    nk, nj, ni = _shape(shape)
    if min(nk, nj, ni) < 2:
        raise ValueError(f"a classified grid needs >= 2 corners per axis, got {shape}")
    if torch.device(device).type == "cpu":
        return classified_grid_plain(tree, origin, res, shape, device, k0)
    device = cuda_device(device)
    lib = build(tree, "classified", True) if parametric else build(tree)
    dist = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    cases = torch.empty((nk - 1, nj - 1, ni - 1), dtype=torch.uint8, device=device)
    check_out(dist, (nk, nj, ni), torch.float32, device)
    check_out(cases, (nk - 1, nj - 1, ni - 1), torch.uint8, device)
    lib.launch("classified_grid", device, dist.data_ptr(), cases.data_ptr(),
               *float_args(origin, res, mc_emit.quick_reject_threshold(res)), int(k0), nk, nj, ni,
               tree=tree)
    return dist, cases


# --- the pruned renderer's coarse pass (K6c) and tile atlas (K6a) -------
def prune_constants(res, S: int):
    """(tres, half, thr) of the coarse pass in float32, in the JAX
    package's arithmetic (pruned.py:58-69): a tile's side S * res, its
    half, and the keep threshold side * f32(sqrt(3) / 2)."""
    tres = _f32(S) * _f32(res)
    return tres, tres * _f32(0.5), tres * _f32(np.sqrt(3) / 2)


def coarse_keep_plain(tree, origin, res, S, shape, device):
    """K6c's plain version: (keep (tz,ty,tx) u8, count (1,) int32)."""
    tz, ty, tx = _shape(shape)
    o = np.asarray(origin, _f32).reshape(3)
    tres, half, thr = (float(v) for v in prune_constants(res, S))

    def axis(n, origin_c):  # origin + idx * (S * res) + half
        idx = torch.arange(n, dtype=torch.int32, device=device).to(torch.float32)
        return float(origin_c) + idx * tres + half

    z = axis(tz, o[2])[:, None, None].expand(tz, ty, tx)
    y = axis(ty, o[1])[None, :, None].expand(tz, ty, tx)
    x = axis(tx, o[0])[None, None, :].expand(tz, ty, tx)
    keep = (torch.abs(tree.distance(torch.stack([x, y, z], dim=-1))) < thr).to(torch.uint8)
    return keep, keep.sum(dtype=torch.int32).reshape(1)


def coarse_keep(tree, origin, res, S, shape, device, parametric: bool = False):
    """The coarse pass of the pruned renderer (K6c): for the (tz, ty, tx)
    tiles of S^3 cubes, (keep u8 1 where |d(centre)| < S*res*sqrt(3)/2,
    count (1,) int32 of kept tiles). parametric=True runs K6cp, the
    library of the tree's structure with its current parameters."""
    tz, ty, tx = _shape(shape)
    if torch.device(device).type == "cpu":
        return coarse_keep_plain(tree, origin, res, S, shape, device)
    device = cuda_device(device)
    lib = build(tree, "prune", parametric)
    n = tz * ty * tx
    buf = torch.empty(-(-n // 4) + 1, dtype=torch.int32, device=device)  # mask, then count
    keep, count = buf.view(torch.uint8)[:n].view(tz, ty, tx), buf[-1:]
    lib.launch("tile_prune", device, keep.data_ptr(), count.data_ptr(),
               *float_args(origin, *prune_constants(res, S)), tz, ty, tx, tree=tree)
    return keep, count


def keep_to_host(keep, count):
    """(keep mask as a numpy u8 array, kept-tile count) on the host. K6c
    writes both into one int32 buffer (the mask's bytes, then the count),
    which comes over in ONE copy; the plain version's tensors are read as
    they are."""
    store = keep.untyped_storage()
    if count.untyped_storage().data_ptr() != store.data_ptr():
        return keep.cpu().numpy(), int(count.cpu()[0])
    host = torch.empty(0, dtype=torch.uint8, device=keep.device).set_(store).cpu()
    n, at = keep.numel(), keep.storage_offset()
    mask = host[at : at + n].numpy().reshape(keep.shape)
    c = count.storage_offset() * count.element_size()
    return mask, int(host[c : c + 4].view(torch.int32)[0])


def _tile_dims(tiles, S, dims):
    S = int(S)
    nx, ny, nz = (int(d) for d in dims)
    if S < 1 or min(nx, ny, nz) < 1 or tiles.ndim != 2 or tiles.shape[1] != 3 \
            or tiles.shape[0] < 1:
        raise ValueError(f"a tile atlas needs T >= 1 tiles (T, 3) and S >= 1, got "
                         f"{tuple(tiles.shape)}, S = {S}, dims {dims}")
    return tiles.shape[0], S, nx, ny, nz


def tile_positions(tiles, origin, res, S, device):
    """(T, P, P, P, 3) float32 corner positions of the T tiles (P = S + 1)
    from their global integer indices: origin + f32(tile * S + local) * res,
    K1's formula (grid_positions)."""
    T, P = tiles.shape[0], int(S) + 1
    tiles = tiles.to(device=device, dtype=torch.int64)
    local = torch.arange(P, dtype=torch.int64, device=device)
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))

    def axis(c):  # (T, P)
        return float(o[c]) + (tiles[:, c, None] * int(S) + local).to(torch.float32) * r

    x = axis(0)[:, None, None, :].expand(T, P, P, P)
    y = axis(1)[:, None, :, None].expand(T, P, P, P)
    z = axis(2)[:, :, None, None].expand(T, P, P, P)
    return torch.stack([x, y, z], dim=-1)


def tile_grid_plain(tree, tiles, origin, res, S, dims, device):
    """K6a's plain version: (dist (T*P, P, P) f32, cases (T*P-1, S, S)
    u8), the cases 0 on the seam layers and past the global grid."""
    T, S, nx, ny, nz = _tile_dims(tiles, S, dims)
    P = S + 1
    dist = tree.distance(tile_positions(tiles, origin, res, S, device)).reshape(T * P, P, P)
    cases = mc_emit.effective_cases(dist, res)
    tiles = tiles.to(device=device, dtype=torch.int64)
    ka = torch.arange(T * P - 1, device=device)
    t, lk = ka // P, ka % P
    local = torch.arange(S, device=device)
    in_k = (lk < S) & (tiles[t, 2] * S + lk < nz)  # lk == S: the seam between two tiles
    in_j = tiles[t, 1, None] * S + local < ny  # (T*P-1, S)
    in_i = tiles[t, 0, None] * S + local < nx
    inside = in_k[:, None, None] & in_j[:, :, None] & in_i[:, None, :]
    return dist, torch.where(inside, cases, 0).to(torch.uint8)


def tile_grid(tree, tiles, origin, res, S, dims, device, parametric: bool = False):
    """The tile atlas (K6a): tiles (T, 3) int32 [i, j, k] tile coordinates
    of S^3-cube tiles, dims (nx, ny, nz) the whole grid's cubes -> (dist
    (T*P, P, P) f32 corner distances, tile t's plane lk at atlas plane
    t*P + lk, P = S + 1; cases (T*P-1, S, S) u8 with K1's effective-case
    rule, 0 on the seam layer between two tiles and on cubes past the
    global grid). K3 and K4 read the pair as an ordinary grid.
    parametric=True runs K6ap."""
    T, S, nx, ny, nz = _tile_dims(tiles, S, dims)
    if torch.device(device).type == "cpu":
        return tile_grid_plain(tree, tiles, origin, res, S, dims, device)
    device = cuda_device(device)
    P = S + 1
    if T * P**3 >= 1 << 31:
        raise ValueError(f"a tile atlas of {T} tiles of {P}^3 corners exceeds int32 indices")
    check_out(tiles, (T, 3), torch.int32, device)
    lib = build(tree, "prune", parametric)
    dist = torch.empty((T * P, P, P), dtype=torch.float32, device=device)
    cases = torch.empty((T * P - 1, S, S), dtype=torch.uint8, device=device)
    lib.launch("tile_atlas", device, dist.data_ptr(), cases.data_ptr(), tiles.data_ptr(), T, S,
               nx, ny, nz, *float_args(origin, res, mc_emit.quick_reject_threshold(res)),
               tree=tree)
    return dist, cases
