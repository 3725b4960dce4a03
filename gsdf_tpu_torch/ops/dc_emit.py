"""K5, dual contouring's device stage (gsdf_tpu/render/dual_contour.py::
dc_mesh_emit :179-508 with the grid eval of _dc_mesh_fn :575-583, and the
edge field of _dc_edges_fn :61-135): tree -> corner distances -> active
edges -> central-difference normals -> per-voxel QEF solve -> vertices.

Two wrappers, each beside its plain torch version:

- `dc_mesh`: the ascending active edge ids (axis * nvox + voxel, int32,
  slab-local), their winding flips and the vertex of every live voxel in
  ascending voxel order: what the host quad emission (render/
  dual_contour.py::finish_dc_mesh) takes. The normals are scaled by
  1/norm_step and the regularisation row by the same (the device QEF of
  the JAX package).
- `dc_edges`: the edge ids, flips, t and the raw central differences: what
  the float64 host oracle (DualContourRenderer(host_qef=True)) reads.

K5's scratch (the corner grid, its work words, the ballot words, the edge
ranks, the live voxel ids) lives in a `K5Scratch`, made per call unless
the caller passes one to keep across calls of one shape, as the chunk
route does (render/dual_contour.py::mesh_chunks).

On a CPU tensor device a wrapper runs the plain version; on a CUDA device
it launches K5 (csrc/dc_mesh.cu; K5p, its parametric form, with
parametric=True) or raises. Sizes are exact: the kernel's count pass
writes the edge and voxel counts, the wrapper reads them once (the one
synchronising call before the fetch) and allocates the outputs; no
padding, no grow-and-retry.

The plain version sums a voxel's rows in the JAX package's order without
its sort: the JAX code argsorts the 5 contributions of every edge by voxel
(stable) and segment-sums them, so a voxel's rows come by edge id and then
by the position in OFF5; that order is the same for every voxel
(ops/dc_tables.py GATHER), and the plain version and K5 gather in it.
The plain version does the floating-point work that K5 does and no more
(bounds.py counts K5's operations on it): t and flip at the active edges,
a voxel's rows where its edges are active.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import mathx as mx
from ..eval.grid_kernels import evaluate_grid_plain
from .dc_tables import GATHER, OFF5

_f32 = np.float32

#: edge ids are int32 (axis * nvox + voxel)
MAX_EDGE_IDS = 1 << 31


class DCMesh(NamedTuple):
    """eids (E,) int32 ascending, flips (E,) bool, verts (V,3) f32 of the
    live voxels in ascending voxel order."""

    eids: torch.Tensor
    flips: torch.Tensor
    verts: torch.Tensor


class DCEdges(NamedTuple):
    """eids (E,) int32 ascending, flips (E,) bool, t (E,) f32, normals
    (E,3) f32: the raw central differences."""

    eids: torch.Tensor
    flips: torch.Tensor
    t: torch.Tensor
    normals: torch.Tensor


def check_shape(shape, n_own=None):
    """(nk, nj, ni, n_own) of a DC grid; raises where edge ids overflow int32."""
    nk, nj, ni = (int(x) for x in shape)
    if min(nk, nj, ni) < 2:
        raise ValueError(f"a dual contour grid needs >= 2 corners per axis, got {shape}")
    nvox = (nk - 1) * (nj - 1) * (ni - 1)
    if 3 * nvox >= MAX_EDGE_IDS:
        # the edge id packs into 31 bits
        raise ValueError("grid too large for int32 edge ids (3*nvox >= 2^31)")
    n_own = nk - 1 if n_own is None else int(n_own)
    if not 1 <= n_own <= nk - 1:
        raise ValueError(f"n_own {n_own} outside [1, {nk - 1}]")
    return nk, nj, ni, n_own


def qef_constants(norm_step, sqrt_lambda):
    """(half, inv_step, l2) in float32, as the JAX package rounds them
    (dual_contour.py:571-573, :368)."""
    half = _f32(norm_step) * _f32(0.5)
    inv_step = _f32(1.0) / _f32(norm_step)
    lam = _f32(sqrt_lambda) * inv_step
    return half, inv_step, lam * lam


# --- plain torch versions ------------------------------------------------
# Each computes only what K5 computes, so that bounds.count_ops over it
# counts K5's floating-point work: t and flip at the active edges only, a
# voxel's rows only where its edge is active.
def edge_flags_plain(grid):
    """(3, L, ny, nx) bool: each voxel's x, y and z edge of the corner grid
    (L+1, ny+1, nx+1), active where the sign bits of its ends differ."""
    d0 = grid[:-1, :-1, :-1]
    ends = (grid[:-1, :-1, 1:], grid[:-1, 1:, :-1], grid[1:, :-1, :-1])
    s0 = torch.signbit(d0)
    return torch.stack([s0 != torch.signbit(de) for de in ends])


def edge_values_plain(d0, de):
    """(t, flip) of edges from d0 to de: t = -d0 / (de - d0, or 1 where
    de == d0), flip (de - d0) < 0."""
    return -d0 / torch.where(de == d0, 1.0, de - d0), (de - d0) < 0


def _voxel_coords(lin, nx, ny):
    return lin % nx, (lin // nx) % ny, lin // (nx * ny)


def _edges_plain(tree, origin, res, shape, device, half, scale, k0):
    """(eids int64, flips, t, points (E,3), normals (E,3)) of the active
    edges; the normals are the central differences times `scale` (raw for
    None)."""
    nk, nj, ni, _ = check_shape(shape)
    nx, ny = ni - 1, nj - 1
    nvox = (nk - 1) * ny * nx
    grid = evaluate_grid_plain(tree, origin, res, shape, device, k0)
    eid = torch.nonzero(edge_flags_plain(grid).reshape(-1)).squeeze(1)  # ascending
    eax = eid // nvox
    ei, ej, ek = _voxel_coords(eid % nvox, nx, ny)
    corner = (ek * nj + ej) * ni + ei
    step = torch.tensor([1, ni, nj * ni], device=eid.device)[eax]
    flat = grid.reshape(-1)
    tv, flips = edge_values_plain(flat[corner], flat[corner + step])
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))
    pt = torch.stack([float(o[0]) + ei.to(torch.float32) * r,
                      float(o[1]) + ej.to(torch.float32) * r,
                      float(o[2]) + (ek + int(k0)).to(torch.float32) * r], dim=-1)
    rows = torch.arange(len(eid), device=eid.device)
    pt[rows, eax] = pt[rows, eax] + tv * r
    eye = torch.from_numpy(np.eye(3, dtype=_f32) * _f32(half)).to(pt.device)
    d6 = tree.distance(torch.cat([pt + eye[d] for d in range(3)]
                                 + [pt - eye[d] for d in range(3)])).reshape(6, -1)
    nrm = torch.stack([d6[d] - d6[3 + d] for d in range(3)], dim=-1)
    if scale is not None:
        nrm = nrm * float(scale)
    return eid, flips, tv, pt, nrm


def dc_edges_plain(tree, origin, res, shape, device, norm_step) -> DCEdges:
    """dc_edges' plain version."""
    half = _f32(norm_step) * _f32(0.5)
    eid, flips, tv, _, nrm = _edges_plain(tree, origin, res, shape, device, half, None, 0)
    return DCEdges(eid.to(torch.int32), flips, tv, nrm)


def _atan2(y, x):
    """atan2 in float32: on the CPU in float64, rounded once (mathx rounds
    sin and cos so); on the card torch's kernel, CUDA's precise atan2f, the
    function K5 calls."""
    return mx._rounded(torch.atan2, y, x)


def qef_solve_plain(s, l2):
    """The clamped QEF solution x (V,3) of the voxels' sums s (V,13), in
    the operations and order of the JAX package (dual_contour.py:366-467)
    and of csrc/gsdf_qef.cuh::qef_solve."""
    l2 = float(_f32(l2))
    cnt = torch.clamp(s[:, 12], min=1.0)
    bias = [s[:, 9 + c] / cnt for c in range(3)]
    m = {(0, 0): s[:, 0] + l2, (0, 1): s[:, 1], (0, 2): s[:, 2],
         (1, 1): s[:, 3] + l2, (1, 2): s[:, 4], (2, 2): s[:, 5] + l2}
    rhs = [
        s[:, 6] - ((s[:, 0] * bias[0] + m[0, 1] * bias[1]) + m[0, 2] * bias[2]),
        s[:, 7] - ((m[0, 1] * bias[0] + s[:, 3] * bias[1]) + m[1, 2] * bias[2]),
        s[:, 8] - ((m[0, 2] * bias[0] + m[1, 2] * bias[1]) + s[:, 5] * bias[2]),
    ]
    tr = (m[0, 0] + m[1, 1]) + m[2, 2]
    one, zero = torch.ones_like(tr), torch.zeros_like(tr)
    v = {(r, c): one if r == c else zero for r in range(3) for c in range(3)}

    def mget(r, c):
        return m[(r, c)] if r <= c else m[(c, r)]

    for _sweep in range(5):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = mget(p, p), mget(q, q), mget(p, q)
            theta = 0.5 * _atan2(2.0 * apq, aqq - app)
            cth, sth = mx.cos(theta), mx.sin(theta)
            o = 3 - p - q
            aop, aoq = mget(o, p), mget(o, q)
            c2, s2, cs = cth * cth, sth * sth, cth * sth
            m[p, p] = c2 * app - 2.0 * cs * apq + s2 * aqq
            m[q, q] = s2 * app + 2.0 * cs * apq + c2 * aqq
            m[p, q] = cs * (app - aqq) + (c2 - s2) * apq
            m[min(o, p), max(o, p)] = cth * aop - sth * aoq
            m[min(o, q), max(o, q)] = sth * aop + cth * aoq
            for r in range(3):
                vp, vq = v[r, p], v[r, q]
                v[r, p] = cth * vp - sth * vq
                v[r, q] = sth * vp + cth * vq
    floor = torch.clamp(1e-6 * tr, min=l2)
    t = [(((0.0 + v[0, c] * rhs[0]) + v[1, c] * rhs[1]) + v[2, c] * rhs[2])
         / (torch.clamp(mget(c, c), min=0.0) + floor) for c in range(3)]
    y = [((0.0 + v[r, 0] * t[0]) + v[r, 1] * t[1]) + v[r, 2] * t[2] for r in range(3)]
    return torch.stack([torch.clamp(bias[r] + y[r], -0.1, 1.1) for r in range(3)], dim=-1)


def qef_rows(nrm, q):
    """The 13 columns each row adds to its voxel's sums (dual_contour.py:
    349-361): the upper triangle of n n^T, n (n . q), q, 1."""
    n0, n1, n2 = nrm[..., 0], nrm[..., 1], nrm[..., 2]
    ndq = (n0 * q[..., 0] + n1 * q[..., 1]) + n2 * q[..., 2]
    return torch.stack([n0 * n0, n0 * n1, n0 * n2, n1 * n1, n1 * n2, n2 * n2,
                        n0 * ndq, n1 * ndq, n2 * ndq, q[..., 0], q[..., 1], q[..., 2],
                        torch.ones_like(ndq)], dim=-1)


def dc_mesh_plain(tree, origin, res, shape, device, norm_step, sqrt_lambda, k0=0,
                  n_own=None) -> DCMesh:
    """dc_mesh's plain version: the torch port of dc_mesh_emit with its k0
    and n_own, on the grid of evaluate_grid_plain."""
    eid, flips, o, idx, sums, l2 = voxel_sums_plain(tree, origin, res, shape, device,
                                                    norm_step, sqrt_lambda, k0, n_own)
    x = qef_solve_plain(sums, l2)
    r = float(_f32(res))
    verts = (o + idx * r) + x * r
    return DCMesh(eid.to(torch.int32), flips, verts)


def live_voxels_plain(eid, shape, n_own):
    """The live voxels of the corner grid `shape`, ascending: the owned
    voxels (layers [0, n_own)) that an active edge (`eid`: ids axis * nvox
    + voxel) gives a row to."""
    nk, nj, ni, n_own = check_shape(shape, n_own)
    nx, ny = ni - 1, nj - 1
    nvox = (nk - 1) * ny * nx
    eax = eid // nvox
    ei, ej, ek = _voxel_coords(eid % nvox, nx, ny)
    cand = []
    for a in range(3):
        sel = eax == a
        for di, dj, dk in OFF5[a]:
            ii, jj, kk = ei[sel] + di, ej[sel] + dj, ek[sel] + dk
            ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny) & (kk >= 0) & (kk < n_own)
            cand.append(((kk * ny + jj) * nx + ii)[ok])
    return torch.unique(torch.cat(cand))  # ascending


def voxel_sums_plain(tree, origin, res, shape, device, norm_step, sqrt_lambda, k0=0,
                     n_own=None):
    """dc_mesh_plain up to the solve: (eids int64, flips, origin (3,),
    the live voxels' grid indices (V,3) f32, their 13 sums (V,13), l2)."""
    nk, nj, ni, n_own = check_shape(shape, n_own)
    nx, ny, layers = ni - 1, nj - 1, nk - 1
    nvox = layers * ny * nx
    half, inv_step, l2 = qef_constants(norm_step, sqrt_lambda)
    eid, flips, _, pt, nrm = _edges_plain(tree, origin, res, shape, device, half, inv_step,
                                          k0)
    uvox = live_voxels_plain(eid, (nk, nj, ni), n_own)
    # each live voxel's rows in summation order, by slot; a voxel adds a
    # row only where that edge is active (adding none leaves the bits of a
    # sum that started at +0.0 as adding a zero row would)
    ui, uj, uk = _voxel_coords(uvox, nx, ny)
    o = torch.from_numpy(np.asarray(origin, _f32).reshape(3)).to(eid.device)
    idx = torch.stack([ui, uj, uk + int(k0)], dim=-1).to(torch.float32)
    sums = torch.zeros((len(uvox), 13), dtype=torch.float32, device=eid.device)
    for a in range(3):
        for di, dj, dk in GATHER[a]:
            ii, jj, kk = ui + di, uj + dj, uk + dk
            key = a * nvox + (kk * ny + jj) * nx + ii
            pos = torch.searchsorted(eid, key).clamp(max=max(len(eid) - 1, 0))
            hit = (ii < nx) & (jj < ny) & (kk < layers) & (eid[pos] == key)
            e = pos[hit]
            q = mx.div(pt[e] - o, _f32(res)) - idx[hit]
            sums[hit] = sums[hit] + qef_rows(nrm[e], q)
    return eid, flips, o, idx, sums, l2


# --- kernel wrappers -------------------------------------------------------
class K5Scratch:
    """K5's scratch buffers for one corner shape and owned-layer count:
    the work words (counts, the scan's status words and ticket, zeroed by
    K5's grid pass), the corner grid, the ballot words and edge ranks (3
    words per 32 voxels each) and the live voxel ids (one int32 per owned
    voxel). Allocated at the first call of a shape and kept for the next
    calls of the same shape; K5 launches on one stream, so a call reuses
    them only after the one before it is done with them."""

    def __init__(self):
        self._key = self._bufs = None

    def buffers(self, lib, nk, nj, ni, n_own, device):
        """(work, dist, ebits, edir, uvox) for this shape on `device`."""
        key = (nk, nj, ni, n_own, device)
        if key != self._key:
            owned = n_own * (nj - 1) * (ni - 1)
            words = -(-(nk - 1) * (nj - 1) * (ni - 1) // 32)
            self._bufs = (
                torch.empty(lib.gsdf_dc_work(nk, nj, ni, n_own), dtype=torch.int64,
                            device=device),
                torch.empty((nk, nj, ni), dtype=torch.float32, device=device),
                torch.empty(3 * words, dtype=torch.int32, device=device),
                torch.empty(3 * words, dtype=torch.int32, device=device),
                torch.empty(owned, dtype=torch.int32, device=device),
            )
            self._key = key
        return self._bufs


def _launch_k5(tree, origin, res, shape, device, n_own, k0, parametric, half, scale, l2,
               with_t, with_verts, scratch=None):
    """Both K5 calls with the one count read between them: (eids, flips,
    t or None, normals, verts or None, the corner grid). `scratch`, a
    K5Scratch, keeps K5's scratch for later calls of this shape."""
    nk, nj, ni, n_own = check_shape(shape, n_own)
    device = kernels.cuda_device(device)
    lib = kernels.build(tree, "dc", parametric)
    work, dist, ebits, edir, uvox = (scratch or K5Scratch()).buffers(lib, nk, nj, ni, n_own,
                                                                     device)
    grid_args = (*kernels.float_args(origin, res), int(k0), nk, nj, ni, n_own)
    params = lib.launch("dc_count", device, dist.data_ptr(), *grid_args, work.data_ptr(),
                        ebits.data_ptr(), edir.data_ptr(), uvox.data_ptr(), tree=tree)
    n_x, n_y, n_z, n_vox = work[:4].tolist()  # the one read of the device counts
    n_edges = n_x + n_y + n_z
    eids = torch.empty(n_edges, dtype=torch.int32, device=device)
    flips = torch.empty(n_edges, dtype=torch.bool, device=device)  # 1 B, written 0 or 1
    tvals = torch.empty(n_edges, dtype=torch.float32, device=device) if with_t else None
    pts = torch.empty((n_edges, 3), dtype=torch.float32, device=device)
    nrm = torch.empty((n_edges, 3), dtype=torch.float32, device=device)
    verts = (torch.empty((n_vox, 3), dtype=torch.float32, device=device) if with_verts
             else None)
    lib.launch("dc_emit", device, dist.data_ptr(), *grid_args, work.data_ptr(), ebits.data_ptr(),
               edir.data_ptr(), uvox.data_ptr(), n_edges, n_vox, float(half), float(scale),
               float(l2), eids.data_ptr(), flips.data_ptr(),
               None if tvals is None else tvals.data_ptr(), pts.data_ptr(), nrm.data_ptr(),
               None if verts is None else verts.data_ptr(), tree=tree, params=params, count=False)
    return eids, flips, tvals, nrm, verts, dist


def dc_mesh(tree, origin, res, shape, device, norm_step, sqrt_lambda, k0=0, n_own=None,
            parametric=False, scratch=None) -> DCMesh:
    """K5: the active edges and the live voxels' vertices of the corner
    grid `shape` (nk, nj, ni) at origin + (i, j, k0 + k) * res. Voxels of
    layers [0, n_own) are owned (all by default); the edges of the layers
    above give rows to them and have ids too. parametric=True runs K5p:
    the library of the tree's structure, with its current parameters.
    `scratch` (a K5Scratch) keeps K5's scratch across calls of one shape;
    the plain version has none."""
    if torch.device(device).type == "cpu":
        return dc_mesh_plain(tree, origin, res, shape, device, norm_step, sqrt_lambda, k0,
                             n_own)
    half, inv_step, l2 = qef_constants(norm_step, sqrt_lambda)
    eids, flips, _, _, verts, _ = _launch_k5(tree, origin, res, shape, device, n_own, k0,
                                          parametric, half, inv_step, l2, False, True, scratch)
    return DCMesh(eids, flips, verts)


def dc_edges(tree, origin, res, shape, device, norm_step) -> DCEdges:
    """K5's edge passes: the active edges of the grid with t and the raw
    central differences (scale 1), for the float64 host oracle."""
    if torch.device(device).type == "cpu":
        return dc_edges_plain(tree, origin, res, shape, device, norm_step)
    half = _f32(norm_step) * _f32(0.5)
    eids, flips, tvals, nrm, _, _ = _launch_k5(tree, origin, res, shape, device, None, 0, False,
                                            half, 1.0, 0.0, True, False)
    return DCEdges(eids, flips, tvals, nrm)
