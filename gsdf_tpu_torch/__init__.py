"""gsdf_tpu_torch — the PyTorch / CUDA port of gsdf_tpu.

The JAX package `gsdf_tpu` beside it is the reference; this package
imports torch, numpy and the standard library only (Pillow where a PNG is
written). Ported so far: the Builder and all 55 node types; the whole
flat renderer (`render.FlatRenderer`: the triangle soup, the welded mesh
and the compact main path, with their z-slab gates and fallbacks) on six
hand-written CUDA kernels — grid evaluation fused with marching-cubes
classification and generated per tree (K1, K2), compaction (K3), the
compact emit (K4), the soup emit (K7s) and the welded emit (K7w) — plus
the native host decode, STL, OBJ and PLY output; the point evaluators
(`eval`: SDF3, SDF2, normals, caches, Batcher, the special evaluators) on
the point kernel KP, and 2D trees to images and PNG files (`render.image`,
`pipeline`) on the pixel-grid kernel K2-2D; parametric evaluation, dual
contouring and pruned rendering on their kernels (K1p, KPp, K5, K6); and
the raymarcher (`visual.raymarch`, the interactive viewer and `ui` in
`pipeline`) on the sphere-tracing kernel K8 and its parametric form K8p.

Every entry point runs on the card unless the caller passes a `device`
(`kernels.default_device`); with no card such a call raises.
"""
from .core import Builder, Flags, Shader2D, Shader3D, ShapeError, with_bounds

#: the version of the JAX package this port follows
__version__ = "0.1.0"

__all__ = ["Builder", "Flags", "Shader2D", "Shader3D", "ShapeError", "__version__",
           "with_bounds"]
