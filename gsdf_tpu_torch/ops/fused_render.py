"""One-pass soup render (gsdf_tpu/ops/fused_render.py:37-134): fused
grid eval + classification (K1), compaction (K3), triangle emit (K7s),
one fetch.

The JAX package traced the whole render as one XLA executable with
guessed buffer sizes and grew them on overflow; here each stage is a
kernel and the sizes are exact device counts, all carried by K3's one
read, so there is no size hint, no retry and no second read before the
fetch.
"""
from __future__ import annotations

from ..eval.grid_kernels import classified_grid
from .mc_emit import dense_grid_mc


def fused_render(tree, origin, res, shape, device, k0: int = 0, parametric: bool = False):
    """Render one grid (or z-slab) of `shape` corner planes. k0 is the
    slab's first plane in the whole grid: positions and the soup's z
    coordinates then equal a whole-grid render bit for bit. Returns tris
    np (T,3,3) float32. parametric=True classifies with K1p (the indexed
    render's soup routes; the public render() has no such argument)."""
    dist, cases = classified_grid(tree, origin, res, shape, device, k0, parametric)
    return dense_grid_mc(dist, cases, origin, res, k0).cpu().numpy()
