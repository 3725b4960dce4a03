"""gsdf_tpu_torch — the PyTorch / CUDA port of gsdf_tpu.

The JAX package `gsdf_tpu` beside it is the reference; this package
imports torch, numpy and the standard library only. The slice ported so
far is the compact SDF->STL main path of the flange and showerhead parts:
Builder, the nine node types they use, a hand-written CUDA kernel pair
for grid evaluation (fused with marching-cubes classification), the
compact emit, the native host decode and the indexed STL writer.
"""
from .core import Builder, Flags, Shader2D, Shader3D, ShapeError

__all__ = ["Builder", "Flags", "Shader2D", "Shader3D", "ShapeError"]
