"""Pruned tile renderer (gsdf_tpu/render/pruned.py): the counterpart of the
reference's heapless octree marching-cubes renderer
(glrender/octreerenderer.go), on the card.

Two levels, as in the JAX package:
1. the coarse pass (K6c, eval/grid_kernels.py::coarse_keep): the tree's
   distance at the centre of every tile of S^3 cubes; a tile is pruned
   where |d(centre)| >= S*res*sqrt(3)/2 (octreerenderer.go:262). The keep
   mask and its count come to the host in one copy, where np.argwhere
   lists the kept tiles in the JAX package's order ([k,j,i], z slowest, as
   [i,j,k] rows);
2. the fine pass per batch of `tiles_per_batch` kept tiles: their corners
   as one atlas grid with its case grid (K6a, `tile_grid`), then
   - compact payload: K3 over the atlas (its one count read), the atlas
     ids made global (`tile_global_ids`), K4, one fetch; the host merges
     the batches into the dense path's payload (`merge_compact_payloads`)
     and decodes it with the native decoder;
   - soup (`read_triangles`, pull-based, one batch of triangles per batch
     of tiles: the reference Renderer contract, glrender/glrender.go:
     11-17): K3, then K7s in tile mode (positions from global indices).

Every atlas corner is evaluated at origin + f32(global index) * res by
K1's formula, so for a 1-Lipschitz field the pruned payload equals the
dense `compact_field_render` payload exactly (ids, case bytes and t).
Pruning is exact only for 1-Lipschitz fields: ops like Twist can exceed
that, as in the reference's octree.

Left out of the port, with the reasons in ROADMAP.md: the `_bucket`
padding of tile batches (the kernels take T as an argument), the size
hints with grow-and-retry (sizes are exact from K3's count read), the v1
full-id wire format (ids, cases and t are fetched as they are) and the
jitted-executable cache. `parametric=True` runs K6cp and K6ap, the
libraries of the tree's structure, so a `rebind` edit renders with no
build; the grid stays pinned to the construction-time bounds.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import Shader3D
from ..eval.grid_kernels import coarse_keep, keep_to_host, tile_grid
from ..kernels import entry_device
from ..native import mc_decode
from ..ops.compact_field import merge_compact_payloads, tile_compact_emit
from ..ops.mc_emit import MAX_CUBES, compact_active, emit_triangles

_f32 = np.float32


class PrunedRenderer:
    """Two-level pruned marching-cubes renderer with streaming output."""

    def __init__(self, s: Shader3D, cube_resolution: float, tile_size: int = 8,
                 tiles_per_batch: int = 2048, device=None):
        if cube_resolution <= 0:
            raise ValueError("invalid renderer cube resolution")
        if int(tile_size) < 1 or int(tiles_per_batch) < 1:
            raise ValueError("tile_size and tiles_per_batch must be at least 1")
        self.s = s
        self.res = _f32(cube_resolution)
        self.S = int(tile_size)
        self.tiles_per_batch = int(tiles_per_batch)
        self.device = entry_device(device)  # the card unless the caller names one

        bb = s.bounds().scale_centered((1.01, 1.01, 1.01))
        sz = bb.size()
        self.nx = int(math.ceil(_f32(sz[0]) / self.res))
        self.ny = int(math.ceil(_f32(sz[1]) / self.res))
        self.nz = int(math.ceil(_f32(sz[2]) / self.res))
        if self.nx <= 0 or self.ny <= 0 or self.nz <= 0:
            # inverted (empty-intersection) bounds too, as the reference
            # renderers reject them (flatrenderer.go:54, octreerenderer.go:232)
            raise ValueError("resolution not fine enough for marching cubes")
        self.origin = bb.min
        self.tx = -(-self.nx // self.S)
        self.ty = -(-self.ny // self.S)
        self.tz = -(-self.nz // self.S)
        self._evaluations = 0
        self._total_pruned = 0
        #: what the last render did: tiles kept, batches run, and the
        #: renders that fell back to FlatRenderer.render_indexed()
        self.kept = 0
        self.batches = 0
        self.fallbacks = 0

    def dims(self):
        """The whole grid's cubes (nx, ny, nz)."""
        return self.nx, self.ny, self.nz

    def evaluations(self) -> int:
        """Distinct SDF points evaluated (coarse tile centres + fine corners
        of kept tiles), the FlatRenderer.evaluations() contract."""
        return self._evaluations

    def total_pruned(self) -> int:
        """Fine-grid evaluations avoided by pruning (the reference reports
        TotalPruned*8 omitted evals, octreerenderer.go:66)."""
        return self._total_pruned

    def _prune(self, parametric: bool = False) -> np.ndarray:
        """The kept tiles, (T, 3) int32 [i, j, k] rows in np.argwhere order
        of the (tz, ty, tx) mask."""
        keep, count = coarse_keep(self.s, self.origin, self.res, self.S,
                                  (self.tz, self.ty, self.tx), self.device, parametric)
        self._evaluations += self.tx * self.ty * self.tz
        keep, n_keep = keep_to_host(keep, count)  # one copy
        tiles = np.ascontiguousarray(np.argwhere(keep)[:, ::-1], dtype=np.int32)
        if len(tiles) != n_keep:
            raise RuntimeError(f"coarse pass: {n_keep} tiles counted, {len(tiles)} in the mask")
        self._total_pruned += (keep.size - n_keep) * (self.S + 1) ** 3
        self.kept = n_keep
        return tiles

    def _batches(self, tiles: np.ndarray):
        """The kept tiles on the device (one upload), `tiles_per_batch` rows
        a batch; counts each batch's corners as evaluated."""
        on_device = torch.from_numpy(tiles).to(self.device)
        self.batches = 0
        for start in range(0, len(tiles), self.tiles_per_batch):
            batch = on_device[start : start + self.tiles_per_batch]
            self.batches += 1
            self._evaluations += len(batch) * (self.S + 1) ** 3
            yield batch

    def read_triangles(self):
        """Yield (n, 3, 3) float32 triangle batches, one per batch of kept
        tiles: the reference Renderer contract's streaming."""
        tiles = self._prune()
        for batch in self._batches(tiles):
            dist, cases = tile_grid(self.s, batch, self.origin, self.res, self.S, self.dims(),
                                    self.device)
            comp = compact_active(cases)
            tris = emit_triangles(dist, cases, comp.ids, self.origin, self.res, 0, comp.n_tris,
                                  comp.tri_offsets, tiles=batch)
            yield tris.cpu().numpy()

    def render(self) -> np.ndarray:
        parts = list(self.read_triangles())
        if not parts:
            return np.empty((0, 3, 3), _f32)
        return np.concatenate(parts, axis=0)

    def compact_payload(self, parametric: bool = False):
        """Pruned compact-field payload (ids u32, cases u8, tvals f32): for
        a 1-Lipschitz field every active cube's tile is kept, so it equals
        the dense path's payload (ops.compact_field.compact_field_render)
        exactly. parametric=True renders through the libraries of the
        tree's structure (K6cp, K6ap): edit the tree's continuous
        parameters (`rebind`) and render again without a build. The grid
        stays pinned to the construction-time bounds: pin generous bounds
        (core.wrappers.with_bounds) before editing."""
        if self.nx * self.ny * self.nz >= MAX_CUBES:
            raise ValueError("grid too large for int32 cube ids")
        tiles = self._prune(parametric)
        parts = []
        for batch in self._batches(tiles):
            dist, cases = tile_grid(self.s, batch, self.origin, self.res, self.S, self.dims(),
                                    self.device, parametric)
            ids, idx8, t = tile_compact_emit(dist, cases, batch, self.dims())
            parts.append((ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(),
                          t.cpu().numpy()))
        return merge_compact_payloads(parts)

    def render_compact(self, parametric: bool = False):
        """Pruned compact-field render to an indexed mesh (verts, tri_idx):
        fine evaluation only on kept tiles, then the dense compact path's
        host decode. Where the decoder finds an unresolvable owner (a
        surface crossing the grid's far faces, or a field that is not
        1-Lipschitz) it returns FlatRenderer.render_indexed() on the same
        device, counted in `fallbacks`. parametric=True: see
        compact_payload; the fallback renders through the same structure's
        library, so an edit never builds."""
        ids, cases, tvals = self.compact_payload(parametric)
        try:
            return mc_decode(ids, cases, tvals, self.nx, self.ny, self.nz, self.origin,
                             self.res)
        except ValueError:
            from .flat import FlatRenderer

            fr = FlatRenderer(self.s, self.res, device=self.device)
            out = fr.render_indexed(parametric)
            self._evaluations += fr.evaluations()
            self.fallbacks += 1
            return out


def render_all(renderer) -> np.ndarray:
    """Drain a streaming renderer (reference glrender.RenderAll,
    glrender.go:17)."""
    return renderer.render()
