"""Flat dense-grid renderer (gsdf_tpu/render/flat.py): every unique grid
corner is evaluated once, and marching cubes runs over the classified
grid. Three outputs:

- `render(fused)`: the triangle soup. fused=True runs K1 + K3 + K7s
  (ops/fused_render.py), in z-slabs past `slab_cubes`; fused=False the
  staged path: K2 grid (z-slabbed past `max_slab_points`), plain torch
  classification, K3, K7s (ops/marching_cubes.py). Each reads K3's
  counts once and nothing else before its fetch.
- `render_indexed()`: the welded mesh, K1 + K3 + K7w (ops/fused_welded.py);
  past `slab_cubes`, or where an owner cube is unresolved, it welds
  `render()`'s soup on the host instead.
- `render_compact()`: the main path, K1 + K3 + K4 and the native host
  decode (ops/compact_field.py), in z-slabs past `compact_cubes`; past
  the int32 id space, or where the decoder cannot resolve an owner, it
  returns `render_indexed()`.

Grid sizing matches the reference exactly (flatrenderer.go:47-56):
bounds scaled 1.01 centered, n = ceil(size/res) per axis in float32. The
memory gates keep the JAX package's values (sized for a 16 GB TPU v5e).
The JAX package's `eval_backend` argument is left out: the staged path
always evaluates with K2.

`render_indexed(parametric=True)` and `render_compact(parametric=True)`
run K1's parametric form on every route: the library is built once per
tree STRUCTURE and reads the tree's continuous parameters from a launch
argument, so `tree.rebind({...})` and a second render need no build
(eval/parametric.py). Such a render never builds or launches a baked
library. The region and the resolution stay pinned at construction: pin
generous bounds (`core.wrappers.with_bounds`) before editing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import Shader3D
from ..eval.grid_kernels import evaluate_grid
from ..kernels import entry_device
from ..native import mc_decode, weld
from ..ops.compact_field import compact_field_render, compact_field_render_slabbed
from ..ops.fused_render import fused_render
from ..ops.fused_welded import welded_render
from ..ops.marching_cubes import marching_cubes_grid
from ..ops.mc_emit import MAX_CUBES

_f32 = np.float32


class FlatRenderer:
    """Dense-grid marching cubes with reference-identical output."""

    #: grid corners past which the soup renders in z-slabs and the indexed
    #: mesh comes from welding the soup. Per cube a slab holds 4 B of
    #: distances, 1 B of cases, 4 B of K3's ids buffer (sized before the
    #: active count is known) and 1/16 B of K3's block offsets; the
    #: indexed mesh adds K3's edge-rank directory, 1/8 B (no cube -> slot
    #: map); then the exact output, 36 B per triangle or 12 B per vertex
    #: and per triangle
    slab_cubes = 48_000_000
    #: grid corners past which the compact path renders in z-slabs. A
    #: dispatch holds 4 B per corner (distances), 1 B per cube (cases) and
    #: 4 B per cube for K3's ids buffer (sized before the active count is
    #: known): 1 GB of ids, about 2.3 GB in all, at 256M
    compact_cubes = 256_000_000

    def __init__(self, s: Shader3D, cube_resolution: float, device=None,
                 max_slab_points: int = 1 << 27):
        if cube_resolution <= 0:
            raise ValueError("invalid renderer cube resolution")
        self.s = s
        self.res = _f32(cube_resolution)
        self.device = entry_device(device)  # the card unless the caller names one
        self.max_slab_points = int(max_slab_points)

        bb = s.bounds().scale_centered((1.01, 1.01, 1.01))
        sz = bb.size()
        # float32 division then ceil, matching flatrenderer.go:50-52
        self.nx = int(math.ceil(_f32(sz[0]) / self.res))
        self.ny = int(math.ceil(_f32(sz[1]) / self.res))
        self.nz = int(math.ceil(_f32(sz[2]) / self.res))
        if self.nx <= 0 or self.ny <= 0 or self.nz <= 0:
            raise ValueError("resolution not fine enough for marching cubes")
        self.origin = bb.min
        self._evaluations = 0

    def shape(self):
        """Corner grid shape (nk, nj, ni)."""
        return self.nz + 1, self.ny + 1, self.nx + 1

    def evaluations(self) -> int:
        """Grid corners whose distances the device computed for this
        renderer's renders (reference Evaluations(), gleval/cpu.go:126),
        counted as the JAX package counts them: the plane a compact slab
        shares with the next counts twice, and a fallback render counts its
        own corners."""
        return self._evaluations

    def _eval_grid(self):
        """All corners by K2, in z-slabs of at most max_slab_points. A
        slab's offset k0 is its integer first plane, so positions are
        origin + (k0 + k) * res and the slabs equal the whole grid bit for
        bit (the rule of gsdf_tpu/render/flat.py:87-92)."""
        nk, nj, ni = self.shape()
        plane = nj * ni
        self._evaluations += nk * plane
        if nk * plane <= self.max_slab_points:
            return evaluate_grid(self.s, self.origin, self.res, (nk, nj, ni), self.device)
        slab_k = max(1, self.max_slab_points // plane)
        slabs = [
            evaluate_grid(
                self.s, self.origin, self.res, (min(slab_k, nk - k), nj, ni),
                self.device, k0=k,
            )
            for k in range(0, nk, slab_k)
        ]
        return torch.cat(slabs, dim=0)

    def render(self, fused: bool = True) -> np.ndarray:
        """Render to a (T,3,3) float32 triangle soup in the reference's
        cube-then-table order. fused=True runs the one-pass path; fused=
        False the staged one (same output; used for cross-checking and for
        grids past max_slab_points)."""
        nk, nj, ni = self.shape()
        if fused and nk * nj * ni <= self.max_slab_points:
            return self._render_fused_slabbed()
        return marching_cubes_grid(self._eval_grid(), self.origin, self.res)

    def soup_slabs(self):
        """(k0, corner shape) of each z-slab of the one-pass soup: one slab
        up to slab_cubes cubes, else equal runs of cube layers, each slab
        sharing its last corner plane with the next."""
        nk, nj, ni = self.shape()
        ncubes = self.nx * self.ny * self.nz
        n_slabs = max(1, min(self.nz, -(-ncubes // self.slab_cubes)))
        bounds_k = [self.nz * s // n_slabs for s in range(n_slabs + 1)]
        return [(k0, (k1 - k0 + 1, nj, ni)) for k0, k1 in zip(bounds_k[:-1], bounds_k[1:])]

    def _render_fused_slabbed(self, parametric: bool = False) -> np.ndarray:
        """The one-pass soup, in z-slabs of cube layers past slab_cubes;
        concatenated in z order they are the whole grid's soup."""
        nk, nj, ni = self.shape()
        self._evaluations += nk * nj * ni
        parts = [
            fused_render(self.s, self.origin, self.res, shape, self.device, k0, parametric)
            for k0, shape in self.soup_slabs()
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def _soup(self, parametric: bool) -> np.ndarray:
        """The soup that render_indexed welds on the host. A parametric
        render takes the one-pass path with K1p whatever the grid's size
        (its slabs bound the memory; the staged path's K2 has no
        parametric form), so it never builds a baked library."""
        return self._render_fused_slabbed(True) if parametric else self.render()

    def render_indexed(self, parametric: bool = False):
        """Render to an indexed mesh (verts (V,3) f32, tri_idx (T,3) i32)
        through the welded emit. Triangle count matches render(); vertex
        coordinates may differ in the last ulp.

        parametric=True builds per tree STRUCTURE: `rebind` the tree's
        continuous parameters (or bind a structurally identical tree via
        self.s) and render again without a build. The region and the
        resolution stay this renderer's.

        Past slab_cubes, or where a triangle edge's owner cube is outside
        the grid or inactive (a surface crossing the grid's far faces), it
        welds the soup instead (weld with tol=0): the JAX package takes
        the first route too but returns wrong indices on the second."""
        nk, nj, ni = self.shape()
        if nk * nj * ni > self.slab_cubes:
            return weld(self._soup(parametric), tol=0.0)
        self._evaluations += nk * nj * ni
        verts, tri_idx, unresolved = welded_render(
            self.s, self.origin, self.res, (nk, nj, ni), self.device, parametric
        )
        if unresolved:
            return weld(self._soup(parametric), tol=0.0)
        return verts, tri_idx

    def render_compact(self, parametric: bool = False):
        """Indexed mesh (verts (V,3) f32, tri_idx (T,3) i32) through the
        compact-field path: K1, K3 and K4 on the device, one fetch of
        ids, case bytes and t, the native host decode. Same counts and
        connectivity as render_indexed(); vertices equal to the last ulp.

        parametric=True as in render_indexed, on every route below.

        Past compact_cubes corners the same kernels run per z-slab and
        the payloads concatenate; past the int32 id space, or where the
        decoder finds an unresolved owner cube, it returns
        render_indexed()."""
        nk, nj, ni = self.shape()
        if self.nx * self.ny * self.nz >= MAX_CUBES:
            return self.render_indexed(parametric)
        if nk * nj * ni > self.compact_cubes:
            ids, cases, tvals, n_pts = compact_field_render_slabbed(
                self.s, self.origin, self.res, (nk, nj, ni), self.device, self.compact_cubes,
                parametric,
            )
            self._evaluations += n_pts
        else:
            self._evaluations += nk * nj * ni
            ids, cases, tvals = compact_field_render(
                self.s, self.origin, self.res, (nk, nj, ni), self.device, 0, parametric
            )
        try:
            return mc_decode(ids, cases, tvals, self.nx, self.ny, self.nz, self.origin, self.res)
        except ValueError:
            return self.render_indexed(parametric)


def render_flat(s: Shader3D, cube_resolution: float, device=None) -> np.ndarray:
    return FlatRenderer(s, cube_resolution, device).render()
