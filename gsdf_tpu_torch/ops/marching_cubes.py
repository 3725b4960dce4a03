"""Staged marching cubes (gsdf_tpu/ops/marching_cubes.py:42-108) over a
device-resident corner grid: classify (plain torch), compact (K3, the one
count read), emit the soup (K7s) at K3's triangle offsets.
FlatRenderer.render(fused=False) runs it on the grid that K2 evaluates;
it cross-checks the one-pass soup (ops/fused_render.py) and serves grids
too large for one fused pass.

Grid convention: grid[k, j, i], shape (nz+1, ny+1, nx+1).
"""
from __future__ import annotations

import numpy as np

from .mc_emit import dense_grid_mc, effective_cases


def marching_cubes_grid(grid, origin, res):
    """Marching cubes over a (nz+1, ny+1, nx+1) float32 distance grid.

    Returns triangles np (T,3,3) float32, in the reference flat
    renderer's order exactly."""
    return dense_grid_mc(grid, effective_cases(grid, np.float32(res)), origin, res).cpu().numpy()
