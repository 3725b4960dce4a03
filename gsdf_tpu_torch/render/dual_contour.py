"""Dual contouring (gsdf_tpu/render/dual_contour.py; reference
glrender/dual_contour.go + dual_contour_vertexplacement.go): one vertex per
surface voxel, placed by a least-squares fit (QEF) to the crossing points
and normals of the voxel's active edges, and one quad per active edge, so
sharp features survive.

- `DualContourRenderer(part, res).render()` runs K5 (ops/dc_emit.py,
  csrc/dc_mesh.cu): grid eval, active edges, central-difference normals,
  the per-voxel QEF and the vertices, all on the card; the host fetches
  the edge ids, flips and vertices at their exact sizes and emits the
  quads (native gsdf_dc_finish). `render(parametric=True)` runs K5p, the
  library of the tree's STRUCTURE: after `part.rebind({...})` it renders
  again without a build (the grid stays pinned to construction-time
  bounds: pin generous bounds with core.wrappers.with_bounds first).
- `host_qef=True`: the float64 host oracle, fed by K5's edge passes
  (`dc_edges`), which solves every voxel's rows with np.linalg.solve, as
  the reference does. It has no parametric mode.
- Past `mono_voxels` voxels the render runs K5 once per z-slab chunk of
  at most `chunk_points` corners (`chunk_plan`: a 2-plane halo, the
  chunk's own voxels only, halo edges dropped on the host, `mesh_chunks`):
  the triangles equal the whole-grid render's bit for bit
  (gsdf_tpu/parallel/sharded_dc.py:148-333 on one device).
- `minecraft_render`: the blocky voxel-face debug mesh, on K2.

The JAX package's v2 wire format (u8 edge-id deltas, escape table, flip
words) and its size hints with grow-and-retry are not ported: the arrays
come from one read of K5's counts, at exact sizes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..core.node import Shader3D
from ..eval.grid_kernels import evaluate_grid
from ..kernels import entry_device
from ..native import dc_finish
from ..ops.dc_emit import K5Scratch, dc_edges, dc_mesh
from ..ops.dc_tables import OFF5 as _OFF5  # noqa: F401  (re-exported)
from ..ops.dc_tables import OFFS as _OFFS

_f32 = np.float32


class DualContourLeastSquares:
    """Least-squares vertex placement (reference
    dual_contour_vertexplacement.go:18-23)."""

    def __init__(self, chiseled: bool = False):
        self.chiseled = chiseled

    @property
    def norm_step(self) -> float:
        # reference dual_contour_vertexplacement.go:42-46
        return 1e-4 if self.chiseled else 2e-8

    @property
    def sqrt_lambda(self) -> float:
        if self.chiseled:
            return math.sqrt(1e-5) * self.norm_step
        return math.sqrt(1e-5)


def _offs() -> np.ndarray:
    return np.array([_OFFS[a] for a in range(3)], np.int32)  # (3,4,3)


def finish_dc_mesh(verts, eax, lin, flips, nx, ny, nz, n_vox):
    """Host quad emission (native gsdf_dc_finish, threaded): (tris (T,3,3)
    f32, block sizes). `eax`/`lin` are the edges' axes and origin-voxel ids
    in the (nx, ny, nz) voxel space, `verts` the vertices of the ascending
    unique voxels the edges touch. Raises where the native library cannot
    be built or the voxels the edges touch are not n_vox; there is no
    numpy fallback (finish_dc_mesh_numpy is the tests' reference)."""
    return dc_finish(verts, eax, lin, flips, nx, ny, nz, n_vox, _offs())


def finish_dc_mesh_numpy(verts, eax, lin, flips, nx, ny, nz, n_vox):
    """finish_dc_mesh in numpy, the reference the native path must equal
    bit for bit: re-derive each quad's corner slots from the edge ids and
    gather the triangles. The ascending unique of all in-range corner and
    own voxel ids is exactly K5's live voxel table (for the chunk route,
    the concatenation of the chunks' tables over disjoint ascending
    ranges), so searchsorted reproduces the kernel's vertex slots."""
    ek = lin // (ny * nx)
    ej = (lin // nx) % ny
    ei = lin % nx
    offs = _offs().astype(np.int64)
    di = offs[eax, :, 0]  # (n,4)
    dj = offs[eax, :, 1]
    dk = offs[eax, :, 2]
    ii2 = ei[:, None] + di
    jj2 = ej[:, None] + dj
    kk2 = ek[:, None] + dk
    in_rng = (ii2 >= 0) & (ii2 < nx) & (jj2 >= 0) & (jj2 < ny) & (kk2 >= 0) & (kk2 < nz)
    clin = (kk2 * ny + jj2) * nx + ii2  # (n,4)
    own = (ek * ny + ej) * nx + ei
    uvox = np.unique(np.concatenate([clin[in_rng], own]))
    if len(uvox) != n_vox:
        raise RuntimeError(
            f"DC payload voxel-count mismatch: derived {len(uvox)} != kernel {n_vox}"
        )
    quad_ok = in_rng.all(axis=1)
    vid = np.searchsorted(uvox, clin)
    verts = np.asarray(verts[:n_vox])
    tris = []
    blocks = []
    # per-axis two-block emission, the host oracle's order
    for a in range(3):
        m = quad_ok & (eax == a)
        if not m.any():
            continue
        quads = verts[vid[m]]  # (E,4,3)
        f = flips[m]
        quads[f] = quads[f][:, ::-1, :]
        tris.append(quads[:, [0, 1, 2], :])
        tris.append(quads[:, [2, 3, 0], :])
        blocks += [int(m.sum())] * 2
    if not tris:
        return np.empty((0, 3, 3), _f32), []
    return np.concatenate(tris, axis=0).astype(_f32), blocks


def _grid_size(s: Shader3D, res32):
    """(origin, nx, ny, nz) of the voxel grid (reference dual_contour.go:
    31-33): bounds shifted by -res/2 so voxel origins straddle the
    surface, ceil in float32, one voxel more per axis."""
    bb = s.bounds().add(np.full(3, -float(res32) / 2, _f32))
    sz = bb.size()
    nx = int(math.ceil(_f32(sz[0]) / res32)) + 1
    ny = int(math.ceil(_f32(sz[1]) / res32)) + 1
    nz = int(math.ceil(_f32(sz[2]) / res32)) + 1
    if nx <= 1 or ny <= 1 or nz <= 1:
        # inverted (empty-intersection) or sub-voxel bounds: reject loudly
        # like the reference grid renderers (flatrenderer.go:54)
        raise ValueError("resolution not fine enough for dual contouring")
    return bb.min, nx, ny, nz


def _fetch(mesh):
    """(eids int64, flips bool, verts f32) of a DCMesh on the host."""
    return (mesh.eids.cpu().numpy().astype(np.int64), mesh.flips.cpu().numpy(),
            mesh.verts.cpu().numpy())


class ChunkPlan(NamedTuple):
    """The chunk route's grid: chunks of c voxel layers, each K5's corner
    grid `shape` (c + 2 planes) from its first layer k0; the voxel space
    (nx, ny, nz_p) padded to whole chunks."""

    origin: np.ndarray
    nx: int
    ny: int
    nz_p: int
    c: int
    shape: tuple
    k0s: list


def chunk_plan(s: Shader3D, res32, max_points) -> ChunkPlan:
    """The chunks of at most `max_points` corners (gsdf_tpu/parallel/
    sharded_dc.py:148-333 on one device): a chunk evaluates c + 2 corner
    planes from its first layer k0, owns its c voxel layers, and its top
    edge layer (the 2-plane halo) only gives rows to its own voxels. k0
    enters position synthesis only, so a voxel's rows keep their values
    and their order and every vertex equals the whole-grid render's."""
    origin, nx, ny, nz = _grid_size(s, res32)
    plane_corners = (ny + 1) * (nx + 1)
    c = max(1, min(int(max_points) // plane_corners - 2, nz))
    n_chunks = -(-nz // c)
    if n_chunks * c >= 1 << 24:
        # layer indices are cast to float32 for positions; past 2^24 the
        # cast rounds and chunks desync from the whole-grid render
        raise ValueError("grid too tall for exact f32 layer indices")
    if 3 * (c + 1) * ny * nx >= 1 << 31:  # a chunk's edge-id space
        raise ValueError(
            "chunk too large for int32 edge ids (3*(c+1)*plane >= 2^31); lower chunk_points"
        )
    return ChunkPlan(origin, nx, ny, n_chunks * c, c, (c + 2, ny + 1, nx + 1),
                     [k * c for k in range(n_chunks)])


def _no_lap(stage):
    pass


def mesh_chunks(s: Shader3D, res32, contourer, device, parametric, chunks, space,
                lap=_no_lap):
    """K5 on each chunk, (origin, corner shape, k0, owned layers or None
    for all), and the fetch of its edges and vertices; then the host quad
    emission over the voxel space (nx, ny, nz). A chunk's edges above its
    owned layers (the halo) are dropped: the next chunk owns them. Returns
    (tris, block sizes, active edges K5 found, bytes fetched); `lap(stage)`
    is called after each stage (stages.py times them)."""
    nx, ny, _ = space
    plane = ny * nx
    parts, verts = [], []
    n_edges = nbytes = 0
    scratch = K5Scratch()  # the chunks share one shape
    for origin, shape, k0, n_own in chunks:
        mesh = dc_mesh(s, origin, res32, shape, device, contourer.norm_step,
                       contourer.sqrt_lambda, k0, n_own, parametric, scratch)
        lap("K5")
        eids, flips, v = _fetch(mesh)
        lap("fetch")
        layers = shape[0] - 1
        nvox = layers * plane
        owned = (layers if n_own is None else n_own) * plane
        # the ids ascend by axis, then voxel: each axis's owned edges are
        # one run of them (the halo's belong to the next chunk)
        ends = np.searchsorted(eids, [a * nvox + b for a in range(3) for b in (0, owned)])
        runs = [(a, ends[2 * a], ends[2 * a + 1]) for a in range(3)]
        parts.append((np.concatenate([np.full(hi - lo, a, np.int64) for a, lo, hi in runs]),
                      np.concatenate([eids[lo:hi] - (a * nvox - k0 * plane) for a, lo, hi in runs]),
                      np.concatenate([flips[lo:hi] for _, lo, hi in runs])))
        verts.append(v)
        n_edges += len(eids)
        nbytes += sum(t.nbytes for t in mesh)
    eax, lin, flips = (np.concatenate(a) for a in zip(*parts))
    tris, blocks = np.empty((0, 3, 3), _f32), []
    if len(eax):
        verts = np.concatenate(verts)
        tris, blocks = finish_dc_mesh(verts, eax, lin, flips, *space, len(verts))
    lap("host finish")
    return tris, blocks, n_edges, nbytes


class DualContourRenderer:
    """Voxel dual contouring to a quad-derived triangle mesh.

    Two QEF backends:
    - device (default): K5, the float32 solve on the card with uniformly
      scaled rows (every row times 1/norm_step: the same argmin, in
      float32's range); the fetch is surface-sized.
    - host_qef=True: the float64 host solve matching the reference's
      semantics row for row (dual_contour_vertexplacement.go:25-141), the
      oracle the device path is held against.
    """

    #: voxels past which a render runs K5 per z-slab chunk (the JAX
    #: package's values; there they kept XLA's compile time in bounds, and
    #: nvcc has no such wall). Here they are the port's memory gate: a
    #: whole-grid render holds 4 B per corner, 4 B per voxel for the live
    #: voxel ids, the plain version's dense fields several times more
    mono_voxels = 12_000_000
    #: corners per chunk on the chunk route
    chunk_points = 4_000_000

    def __init__(self, s: Shader3D, res: float, contourer: DualContourLeastSquares | None = None,
                 device=None, host_qef: bool = False):
        if res <= 0:
            raise ValueError("invalid dual contour resolution")
        self.s = s
        self.res = _f32(res)
        self.contourer = contourer or DualContourLeastSquares()
        self.device = entry_device(device)  # the card unless the caller names one
        self.origin, self.nx, self.ny, self.nz = _grid_size(s, self.res)
        self._evaluations = 0
        self.host_qef = bool(host_qef)

    def shape(self):
        """Corner grid shape (nk, nj, ni)."""
        return self.nz + 1, self.ny + 1, self.nx + 1

    def evaluations(self) -> int:
        """SDF points evaluated: every corner once (a chunk's halo planes
        again) and 6 per active edge for its normal."""
        return self._evaluations

    def render(self, parametric: bool = False) -> np.ndarray:
        """(T,3,3) float32 triangles. parametric=True runs K5p, built per
        tree STRUCTURE: a rebind edit renders through the same library.
        The host oracle has no parametric mode."""
        if self.host_qef:
            return self._render_host()
        return self._render_device(parametric=parametric)

    def chunks(self):
        """(K5 calls [(origin, corner shape, k0, owned layers or None)],
        voxel space (nx, ny, nz)) of a device render: the whole grid, or
        past mono_voxels the chunks of chunk_plan over the padded space."""
        if self.nz * self.ny * self.nx <= self.mono_voxels:
            return [(self.origin, self.shape(), 0, None)], (self.nx, self.ny, self.nz)
        plan = chunk_plan(self.s, self.res, self.chunk_points)
        return ([(plan.origin, plan.shape, k0, plan.c) for k0 in plan.k0s],
                (plan.nx, plan.ny, plan.nz_p))

    def _render_device(self, parametric: bool = False) -> np.ndarray:
        chunks, space = self.chunks()
        tris, blocks, n_edges, _ = mesh_chunks(self.s, self.res, self.contourer, self.device,
                                               parametric, chunks, space)
        # every chunk's corners (halo planes included) and 6 per active edge
        self._evaluations += sum(math.prod(shape) for _, shape, _, _ in chunks) + 6 * n_edges
        self._debug_blocks = blocks
        return tris

    def _render_host(self) -> np.ndarray:
        nk, nj, ni = self.shape()
        nvox = self.nz * self.ny * self.nx
        edges = dc_edges(self.s, self.origin, self.res, (nk, nj, ni), self.device,
                         self.contourer.norm_step)
        self._evaluations += nk * nj * ni
        eid = edges.eids.cpu().numpy().astype(np.int64)
        flip_all = edges.flips.cpu().numpy()
        tv = edges.t.cpu().numpy()
        e_nrm = edges.normals.cpu().numpy()
        if len(eid) == 0:
            return np.empty((0, 3, 3), _f32)
        self._evaluations += 6 * len(eid)  # the central differences
        axis_all = eid // nvox
        rem = eid % nvox
        ke = rem // (self.ny * self.nx)
        je = (rem // self.nx) % self.ny
        ie = rem % self.nx

        # crossing points (the kernel's arithmetic)
        e_pts = np.stack(
            [
                self.origin[0] + ie.astype(_f32) * self.res,
                self.origin[1] + je.astype(_f32) * self.res,
                self.origin[2] + ke.astype(_f32) * self.res,
            ],
            axis=-1,
        )
        bump = tv.astype(_f32) * self.res
        for a in range(3):
            m = axis_all == a
            e_pts[m, a] += bump[m]

        # --- sparse edge -> voxel contributions ----------------------------
        # Each active edge contributes its (normal, crossing) row to the 4
        # voxels sharing it (the quad corners) and twice to its own voxel
        # (the reference duplicates own-edge rows,
        # dual_contour_vertexplacement.go:57-63), on the active sets only.
        nz_, ny_, nx_ = self.nz, self.ny, self.nx
        con_edge = []
        con_vox = []
        edge_corners = {}  # axis -> (edge subset ids, (E,4) voxel lin, ok)
        for a in range(3):
            sel = np.nonzero(axis_all == a)[0]
            k, j, i = ke[sel], je[sel], ie[sel]
            corners = []
            all_ok = np.ones(len(sel), bool)
            for (di, dj, dk) in _OFFS[a]:
                kk2, jj2, ii2 = k + dk, j + dj, i + di
                ok = (
                    (kk2 >= 0) & (kk2 < nz_)
                    & (jj2 >= 0) & (jj2 < ny_)
                    & (ii2 >= 0) & (ii2 < nx_)
                )
                lin = (kk2 * ny_ + jj2) * nx_ + ii2
                corners.append(np.where(ok, lin, -1))
                all_ok &= ok
                con_edge.append(sel[ok])
                con_vox.append(lin[ok])
            # own-voxel duplicate row (offset (0,0,0) is always in range)
            own = (k * ny_ + j) * nx_ + i
            con_edge.append(sel)
            con_vox.append(own)
            edge_corners[a] = (sel, np.stack(corners, axis=1), all_ok)
        con_edge = np.concatenate(con_edge)
        con_vox = np.concatenate(con_vox)

        uvox, inv = np.unique(con_vox, return_inverse=True)
        V = len(uvox)
        counts = np.bincount(inv, minlength=V)
        order = np.argsort(inv, kind="stable")
        s_inv = inv[order]
        s_edge = con_edge[order]
        seg_start = np.zeros(V, np.int64)
        np.cumsum(counts[:-1], out=seg_start[1:])
        row_pos = np.arange(len(order)) - seg_start[s_inv]

        # voxel origins from linear ids
        vk = uvox // (ny_ * nx_)
        vj = (uvox // nx_) % ny_
        vi = uvox % nx_
        vo = np.stack(
            [
                self.origin[0] + vi.astype(_f32) * self.res,
                self.origin[1] + vj.astype(_f32) * self.res,
                self.origin[2] + vk.astype(_f32) * self.res,
            ],
            axis=-1,
        ).astype(np.float64)  # (V,3)
        res = float(self.res)
        inv_res = 1.0 / res

        # --- QEF rows: up to 15 contribution rows + 3 regularisation rows ---
        R = 18
        A = np.zeros((V, R, 3), np.float64)
        B = np.zeros((V, R), np.float64)
        q = (e_pts[s_edge].astype(np.float64) - vo[s_inv]) * inv_res
        n = e_nrm[s_edge].astype(np.float64)
        A[s_inv, row_pos] = n
        B[s_inv, row_pos] = np.einsum("ij,ij->i", n, q)

        # mean bias over the contribution rows (reference biasVerts mean)
        Qsum = np.zeros((V, 3), np.float64)
        np.add.at(Qsum, s_inv, q)
        bias = Qsum / np.maximum(counts, 1)[:, None]

        sq = self.contourer.sqrt_lambda
        for d in range(3):
            A[np.arange(V), 15 + d, d] = sq
            B[:, 15 + d] = sq * bias[:, d]

        # float64 normal equations; the sqrt(1e-5) rows keep AtA
        # nonsingular (unused rows are zero and drop out of the products)
        AtA = np.einsum("vri,vrj->vij", A, A)
        Atb = np.einsum("vri,vr->vi", A, B)
        x = np.linalg.solve(AtA, Atb[..., None])[..., 0]
        x = np.clip(x, -0.1, 1.1)
        final_verts = (x * res + vo).astype(_f32)  # (V,3)

        # --- quad emission per active edge ---------------------------------
        # corner voxel ids resolve by binary search over the sorted active
        # voxel keys (every in-range corner received this edge's row)
        tris = []
        for a in range(3):
            sel, corners, all_ok = edge_corners[a]
            if not len(sel):
                continue
            corners = corners[all_ok]
            flip = flip_all[sel][all_ok]
            vid = np.searchsorted(uvox, corners)
            quads = final_verts[vid]  # (E,4,3)
            quads[flip] = quads[flip][:, ::-1, :]
            tris.append(quads[:, [0, 1, 2], :])
            tris.append(quads[:, [2, 3, 0], :])
        if not tris:
            return np.empty((0, 3, 3), _f32)
        self._debug_blocks = [len(t) for t in tris]
        return np.concatenate(tris, axis=0).astype(_f32)


def minecraft_render(s: Shader3D, res: float, device=None) -> np.ndarray:
    """Axis-aligned voxel-face debug render (reference minecraftRender,
    glrender/dual_contour.go:297-403): each sign-crossing voxel edge emits
    the voxel face it pierces, a blocky mesh. The corner grid is K2's."""
    dc = DualContourRenderer(s, res, device=device)
    nk, nj, ni = dc.shape()
    grid = evaluate_grid(dc.s, dc.origin, dc.res, (nk, nj, ni), dc.device).cpu().numpy()
    d0 = grid[: dc.nz, : dc.ny, : dc.nx]
    r = float(dc.res)
    tris = []
    # per axis: face at the edge end, spanned by the two other axes
    specs = [
        (grid[: dc.nz, : dc.ny, 1:], 0, (0, 1, 0), (0, 0, 1)),  # x faces
        (grid[: dc.nz, 1:, : dc.nx], 1, (0, 0, 1), (1, 0, 0)),  # y faces
        (grid[1:, : dc.ny, : dc.nx], 2, (1, 0, 0), (0, 1, 0)),  # z faces
    ]
    for dend, axis, ua, ub in specs:
        active = np.signbit(d0) != np.signbit(dend)
        idx = np.argwhere(active)  # (E,3) [k,j,i]
        if len(idx) == 0:
            continue
        flip = (dend - d0)[active] < 0
        base = np.stack(
            [
                dc.origin[0] + idx[:, 2] * r,
                dc.origin[1] + idx[:, 1] * r,
                dc.origin[2] + idx[:, 0] * r,
            ],
            axis=-1,
        ).astype(_f32)
        base[:, axis] += r  # face sits at the edge end
        a = np.asarray(ua, _f32) * r
        b = np.asarray(ub, _f32) * r
        q0 = base
        q1 = base + a
        q2 = base + a + b
        q3 = base + b
        t1 = np.stack([q0, q1, q2], axis=1)
        t2 = np.stack([q2, q3, q0], axis=1)
        t1[flip] = t1[flip][:, ::-1, :]
        t2[flip] = t2[flip][:, ::-1, :]
        tris.append(t1)
        tris.append(t2)
    if not tris:
        return np.empty((0, 3, 3), _f32)
    return np.concatenate(tris, axis=0).astype(_f32)
