"""Compact-field emit (gsdf_tpu/ops/compact_field.py), plain torch on the
grid's device.

From the classified grid, the device keeps only what the host decoder
needs: the ascending ids of the active cubes, their case bytes, and the
interpolation parameter t of every crossing owner edge, compacted
cube-major with axes x, y, z. The host walks the MC tables
(native.mc_decode), as the reference does (glrender/octreerenderer.go:131
-> marchcubes.go:34).

The JAX package packs ids as u8 deltas for its slow device link
(compact_field.py:22-30); the port fetches ids (u32), cases (u8) and t
(f32) as they are, with identical decoded arrays. `torch.nonzero` sizes
the compaction exactly, so no grow-and-retry is needed. The compaction
(K3) and this emit (K4) are the next kernels to write by hand.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import mathx as mx
from ..eval.grid_kernels import classified_grid
from .mc_emit import MC_EPS

MAX_CUBES = 1 << 31  # int32 cube ids


def _owner_edge_t(v0, vfar):
    """t on the 3 low (owner) edges of each cube, with the reference's
    epsilon rules (mcInterpolate, marchcubes.go:76-98) baked in (0, 1 or
    0.5). v0 (A,1), vfar (A,3) -> (A,3)."""
    eps = mx.const(MC_EPS, v0)  # compared in float32, as the JAX package does
    ca = torch.abs(v0) < eps
    cb = torch.abs(vfar) < eps
    t = torch.where(ca & cb, 0.5, (0.0 - v0) / (vfar - v0))
    t = torch.where(cb & ~ca, 1.0, t)
    t = torch.where(ca & ~cb, 0.0, t)
    return t


def crossing(idx8):
    """(A,3) bool: which owner edges x, y, z cross, from the sign bits."""
    b0 = idx8 & 1
    return torch.stack(
        [b0 != ((idx8 >> 1) & 1), b0 != ((idx8 >> 3) & 1), b0 != ((idx8 >> 4) & 1)],
        dim=-1,
    )


def compact_emit(grid, cases):
    """grid (nk,nj,ni) corner distances, cases (nk-1,nj-1,ni-1) u8
    effective cases -> (ids int64 ascending, case bytes u8, t f32)."""
    nk, nj, ni = grid.shape
    nx, ny = ni - 1, nj - 1
    flat = cases.reshape(-1)
    ids = torch.nonzero(flat).squeeze(1)  # ascending cube ids
    idx8 = flat[ids]
    ci = ids % nx
    cj = (ids // nx) % ny
    ck = ids // (nx * ny)
    base = ck * (nj * ni) + cj * ni + ci
    strides = torch.tensor([0, 1, ni, nj * ni], dtype=ids.dtype, device=ids.device)
    v4 = grid.reshape(-1)[base[:, None] + strides[None, :]]  # (A,4): v0,vx,vy,vz
    t = _owner_edge_t(v4[:, 0:1], v4[:, 1:])
    return ids, idx8, t[crossing(idx8)]  # boolean mask: cube-major, x,y,z


def compact_field_render(tree, origin, res, shape, device):
    """Classify on the device (K1), compact, fetch. Returns (ids (A,) u32,
    cases (A,) u8, tvals (V,) f32) as numpy arrays for native.mc_decode."""
    nk, nj, ni = (int(x) for x in shape)
    if (nk - 1) * (nj - 1) * (ni - 1) >= MAX_CUBES:
        raise ValueError("grid too large for int32 cube ids")
    dist, cases = classified_grid(tree, origin, res, (nk, nj, ni), device)
    ids, idx8, tvals = compact_emit(dist, cases)
    return (
        ids.to(torch.int32).cpu().numpy().view(np.uint32),
        idx8.cpu().numpy(),
        tvals.cpu().numpy(),
    )
