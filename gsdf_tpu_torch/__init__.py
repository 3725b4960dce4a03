"""gsdf_tpu_torch — the PyTorch / CUDA port of gsdf_tpu.

The JAX package `gsdf_tpu` beside it is the reference; this package
imports torch, numpy and the standard library only. The slice ported so
far is the compact SDF->STL main path for any tree the Builder makes:
Builder and all 55 node types, a hand-written CUDA kernel pair for grid
evaluation (fused with marching-cubes classification) generated per
tree, the compact emit, the native host decode and the indexed STL
writer.
"""
from .core import Builder, Flags, Shader2D, Shader3D, ShapeError, with_bounds

__all__ = ["Builder", "Flags", "Shader2D", "Shader3D", "ShapeError", "with_bounds"]
