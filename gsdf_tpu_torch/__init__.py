"""gsdf_tpu_torch — the PyTorch / CUDA port of gsdf_tpu.

The JAX package `gsdf_tpu` beside it is the reference; this package
imports torch, numpy and the standard library only. Ported so far: the
Builder and all 55 node types; the whole flat renderer
(`render.FlatRenderer`: the triangle soup, the welded mesh and the
compact main path, with their z-slab gates and fallbacks) on six
hand-written CUDA kernels — grid evaluation fused with marching-cubes
classification and generated per tree (K1, K2), compaction (K3), the
compact emit (K4), the soup emit (K7s) and the welded emit (K7w) — plus
the native host decode, STL, OBJ and PLY output.
"""
from .core import Builder, Flags, Shader2D, Shader3D, ShapeError, with_bounds

__all__ = ["Builder", "Flags", "Shader2D", "Shader3D", "ShapeError", "with_bounds"]
