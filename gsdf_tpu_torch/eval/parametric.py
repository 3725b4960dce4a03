"""Parametric evaluation (gsdf_tpu/eval/parametric.py): a tree's
continuous parameters travel to the card as data, so an edited part
re-renders and re-evaluates WITHOUT a new kernel build.

The baked kernels hold every node parameter as a float literal
(codegen/cuda.py): the tightest code, but editing any dimension is a new
tree hash, a new source and an nvcc run. Here a tree's *continuous*
parameters (each node class's `CONT_PARAMS`) are packed into one float32
vector; the per-tree kernels are generated and built once per tree
STRUCTURE (`codegen.cuda.tree_source(tree, parametric=True)`), read the
vector from a kernel argument, and serve every structurally equal tree:
other radii, offsets, blend radii, twists. Structural parameters
(anything an emitter or a Python branch decides by: a cylinder's rounding
mode, arc angles, polygon vertices, instance counts) stay baked, and
changing them builds as before.

The vector, its layout in the kernels and the libraries' key live in
codegen/params.py (`param_spec`, `pack_params`, `structural_hash`,
`kernel_index`, `kernel_params`, re-exported here), below the layer that
builds and launches the kernels.

The JAX package binds tracers onto node attributes while it traces
(`_bind_params`, `binding_active`); the port binds nothing: its plain
version reads a node's live attributes, which `rebind` has already set.

Usage:
    psdf = ParametricSDF3(tree)          # builds once per structure
    d    = psdf.evaluate(pts)            # the tree's current parameters
    d2   = psdf.evaluate(pts, tree2)     # tree2: same structure, new values
"""
from __future__ import annotations

import numpy as np
import torch

from ..codegen.params import (  # noqa: F401  (param_spec .. kernel_params re-exported)
    _layout,
    kernel_index,
    kernel_params,
    pack_params,
    param_spec,
    structural_hash,
)
from ..core.node import Shader, Shader2D, Shader3D
from ..kernels import entry_device

_f32 = np.float32


class _ParametricBase:
    _ndim = 3

    def __init__(self, tree: Shader, device=None):
        self.tree = tree
        self.device = entry_device(device)
        self._hash = structural_hash(tree)

    def n_params(self) -> int:
        return _layout(self.tree)[2]

    def evaluate(self, pos: np.ndarray, tree: Shader | None = None) -> np.ndarray:
        """Distances (N,) at pos (N, ndim) with the (possibly edited)
        tree's current parameter values. `tree` may be any structurally
        identical tree: it runs through this tree's kernel library."""
        from .point_kernels import evaluate_points

        src = tree if tree is not None else self.tree
        if tree is not None and structural_hash(tree) != self._hash:
            raise ValueError("tree structure differs from the compiled structure")
        # the kernel wrapper packs src's values itself; here only the count
        n, expected = _layout(src)[2], self.n_params()
        if n != expected:
            raise ValueError(
                f"parameter count mismatch ({n} vs {expected}): the "
                "edited tree must share subtrees the same way as the "
                "compiled tree"
            )
        pos = np.ascontiguousarray(pos, _f32)
        if pos.ndim != 2 or pos.shape[1] != self._ndim:
            raise ValueError(f"expected (N,{self._ndim}) positions, got {pos.shape}")
        out = evaluate_points(
            src, torch.from_numpy(pos).to(self.device), self.device, parametric=True
        )
        return out.cpu().numpy()


class ParametricSDF3(_ParametricBase):
    _ndim = 3

    def __init__(self, tree: Shader3D, device=None):
        if not isinstance(tree, Shader3D):
            raise TypeError("expected Shader3D")
        super().__init__(tree, device)


class ParametricSDF2(_ParametricBase):
    _ndim = 2

    def __init__(self, tree: Shader2D, device=None):
        if not isinstance(tree, Shader2D):
            raise TypeError("expected Shader2D")
        super().__init__(tree, device)
