"""Flat dense-grid renderer (gsdf_tpu/render/flat.py), compact path.

Grid sizing matches the reference exactly (flatrenderer.go:47-56):
bounds scaled 1.01 centered, n = ceil(size/res) per axis in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import Shader3D
from ..native import mc_decode
from ..ops.compact_field import compact_field_render

_f32 = np.float32


class FlatRenderer:
    """Dense-grid marching cubes with reference-identical output."""

    def __init__(self, s: Shader3D, cube_resolution: float, device):
        if cube_resolution <= 0:
            raise ValueError("invalid renderer cube resolution")
        self.s = s
        self.res = _f32(cube_resolution)
        self.device = torch.device(device)

        bb = s.bounds().scale_centered((1.01, 1.01, 1.01))
        sz = bb.size()
        # float32 division then ceil, matching flatrenderer.go:50-52
        self.nx = int(math.ceil(_f32(sz[0]) / self.res))
        self.ny = int(math.ceil(_f32(sz[1]) / self.res))
        self.nz = int(math.ceil(_f32(sz[2]) / self.res))
        if self.nx <= 0 or self.ny <= 0 or self.nz <= 0:
            raise ValueError("resolution not fine enough for marching cubes")
        self.origin = bb.min

    def shape(self):
        """Corner grid shape (nk, nj, ni)."""
        return self.nz + 1, self.ny + 1, self.nx + 1

    def render_compact(self):
        """Indexed mesh (verts (V,3) f32, tri_idx (T,3) i32) through the
        compact-field path: fused eval + classify on the device (K1),
        compaction and owner-edge t, one fetch, native host decode.

        The JAX package re-renders through render_indexed when the decoder
        finds an unresolved owner cube (non-Lipschitz fields); that path is
        not ported yet, so the port raises the decoder's ValueError there.
        The golden parts never take it."""
        ids, cases, tvals = compact_field_render(
            self.s, self.origin, self.res, self.shape(), self.device
        )
        return mc_decode(
            ids, cases, tvals, self.nx, self.ny, self.nz, self.origin, self.res
        )
