"""Plain PyTorch marching cubes over a dense grid: the benchmark's reference
mesh of a part at a resolution, in the published flat renderer's order and
arithmetic (glrender/flatrenderer.go, marchcubes.go). It imports nothing of
the program under test.

- Grid: the part's bounds scaled by 1.01 about their centre; cubes of side
  diagonal / resdiv; ceil(size / side) cubes an axis, in float32.
- Corner positions origin + index * side in float32; distances of the
  part at every corner.
- A cube is active where its corner 0 lies within 2 sqrt(3) sides of the
  surface and its corners differ in sign; its triangles follow the table,
  cube after cube (x fastest, then y, then z), the vertices of each in
  reversed table order, each vertex interpolated along its cube edge.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import sdf
from .mc_tables import CORNERS, EDGES, TRIANGLES

_f32 = np.float32
#: 2 sqrt(3) with the published kernel's constant (glrender.go:9)
CUBE_DIAG_FACTOR = _f32(2 * 1.73205080757)
EDGE_EPS = 1e-12
#: corners evaluated per call of the part's distance
CHUNK = 1 << 22


class Grid(NamedTuple):
    origin: np.ndarray  # (3,) float32
    res: np.float32
    cubes: tuple  # (nx, ny, nz)


class Mesh(NamedTuple):
    tris: torch.Tensor  # (T, 3, 3) float32 soup
    active: int  # active cubes
    crossings: int  # crossing edges owned by active cubes (x, y, z from corner 0)


def grid(box, resdiv: int) -> Grid:
    """The flat renderer's grid over a part whose bounds are `box`."""
    res = _f32(sdf.diagonal(box) / resdiv)
    lo, hi = sdf.scale_centered(box, 1.01)
    size = (hi - lo).astype(_f32)
    n = tuple(int(math.ceil(_f32(s) / res)) for s in size)
    return Grid(lo, res, n)


def distances(part, g: Grid, device, dtype=torch.float32) -> torch.Tensor:
    """(nz+1, ny+1, nx+1) float32 distances at the grid's corners; the part
    evaluated on `dtype` points (bfloat16 for the control)."""
    nx, ny, nz = g.cubes
    r = float(g.res)
    o = [float(v) for v in g.origin]

    def axis(n, c):
        return c + torch.arange(n, dtype=torch.int32, device=device).to(torch.float32) * r

    x, y, z = axis(nx + 1, o[0]), axis(ny + 1, o[1]), axis(nz + 1, o[2])
    plane = (nx + 1) * (ny + 1)
    out = torch.empty(((nz + 1) * plane,), dtype=torch.float32, device=device)
    xy = torch.stack([x[None, :].expand(ny + 1, nx + 1), y[:, None].expand(ny + 1, nx + 1)],
                     dim=-1).reshape(-1, 2)
    planes = max(1, CHUNK // plane)
    for k0 in range(0, nz + 1, planes):
        kz = z[k0:k0 + planes]
        p = torch.cat([xy.repeat(len(kz), 1), kz.repeat_interleave(plane)[:, None]], dim=1)
        out[k0 * plane:(k0 + len(kz)) * plane] = part.distance(p.to(dtype)).to(torch.float32)
    return out.reshape(nz + 1, ny + 1, nx + 1)


def _table(device):
    tri = torch.full((256, 15), -1, dtype=torch.int64)
    for c, edges in enumerate(TRIANGLES):
        tri[c, :len(edges)] = torch.tensor(edges, dtype=torch.int64)
    count = torch.tensor([len(e) // 3 for e in TRIANGLES], dtype=torch.int64)
    return tri.to(device), count.to(device)


def mesh(dist: torch.Tensor, g: Grid) -> Mesh:
    """The triangle soup of the distances `dist` on grid `g`."""
    nk, nj, ni = dist.shape
    device = dist.device
    corner = [dist[dz:nk - 1 + dz, dy:nj - 1 + dy, dx:ni - 1 + dx] for dx, dy, dz in CORNERS]
    case = torch.zeros(corner[0].shape, dtype=torch.int64, device=device)
    for b, v in enumerate(corner):
        case |= (v < 0.0).to(torch.int64) << b
    near = torch.abs(corner[0]) <= float(CUBE_DIAG_FACTOR * g.res)
    ids = torch.nonzero((near & (case != 0) & (case != 255)).reshape(-1)).squeeze(1)
    case = case.reshape(-1)[ids]
    v = torch.stack([c.reshape(-1)[ids] for c in corner], dim=1)  # (A, 8)
    nx, ny = ni - 1, nj - 1
    ci, cj, ck = ids % nx, (ids // nx) % ny, ids // (nx * ny)
    r = float(g.res)
    o = [float(x) for x in g.origin]
    base = torch.stack([o[0] + ci.to(torch.float32) * r, o[1] + cj.to(torch.float32) * r,
                        o[2] + ck.to(torch.float32) * r], dim=-1)
    offs = torch.tensor(CORNERS, dtype=torch.float32, device=device)
    pc = base[:, None, :] + offs[None] * r  # (A, 8, 3)
    ea = torch.tensor([a for a, _ in EDGES], device=device)
    eb = torch.tensor([b for _, b in EDGES], device=device)
    va, vb, pa, pb = v[:, ea], v[:, eb], pc[:, ea], pc[:, eb]
    eps = torch.tensor(EDGE_EPS, dtype=torch.float32, device=device)
    ca, cb = torch.abs(va) < eps, torch.abs(vb) < eps
    t = torch.where(ca & cb, 0.5, (0.0 - va) / (vb - va))
    pt = pa + t[..., None] * (pb - pa)
    pt = torch.where((cb & ~ca)[..., None], pb, pt)
    pt = torch.where((ca & ~cb)[..., None], pa, pt)  # (A, 12, 3)
    tri, count = _table(device)
    rows = torch.arange(len(ids), device=device)[:, None, None]
    tris = pt[rows, tri[case].reshape(-1, 5, 3).clamp(min=0)].flip(2)  # (A, 5, 3, 3)
    valid = torch.arange(5, device=device)[None, :] < count[case][:, None]
    b0 = case & 1
    crossings = sum(int((b0 != ((case >> b) & 1)).sum()) for b in (1, 3, 4))
    return Mesh(tris[valid], len(ids), crossings)


def reference_mesh(part, box, resdiv: int, device, dtype=torch.float32) -> tuple:
    """(Grid, Mesh) of `part` at `resdiv` over the region `box`."""
    g = grid(box, resdiv)
    return g, mesh(distances(part, g, device, dtype), g)
