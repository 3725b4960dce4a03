"""Point and pixel-grid evaluation on the card: the two per-tree kernels
behind the evaluators and the 2D image renderer.

- KP `evaluate_points`: distances (N,) f32 at positions (N, NDIM) f32,
  for a 3D or a 2D tree. Counterpart of the XLA-jitted `tree.distance`
  that the JAX package's SDF3/SDF2 run (gsdf_tpu/eval/evaluator.py:44).
- K2-2D `distance_field`: a 2D tree's distances on a width x height pixel
  grid over its bounds, row 0 at the top, positions made in the kernel.
  Counterpart of the same jit on a host-made pixel grid
  (gsdf_tpu/render/image.py:53).

Both are hand-written CUDA C++ templates (csrc/point_eval.cu,
csrc/grid_eval_2d.cu) around the tree's generated `gsdf_tree`, each
built into a library of its own ("point" and "field" of
kernels.LIBRARIES) at its wrapper's first CUDA call. On the CPU a wrapper
runs its plain torch version; on a CUDA device it launches its kernel or
raises.

KP has a parametric form, KPp (`evaluate_points(..., parametric=True)`):
the same template around the tree's parametric source, one library per
tree structure, the tree's continuous parameters a launch argument
(kernels.py). Counterpart of the jit behind the JAX package's
ParametricSDF3/2 (gsdf_tpu/eval/parametric.py:147-175).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.node import Shader2D
from ..kernels import build, check_out, entry_device

_f32 = np.float32


# --- plain torch versions ------------------------------------------------
def point_eval_plain(tree, pos: torch.Tensor) -> torch.Tensor:
    """KP's plain version: the torch node tree on the given positions."""
    return tree.distance(pos)


def pixel_grid(tree, width: int, height: int):
    """(xmin, ymax, dx, dy) in float32 of the pixel grid that covers the 2D
    tree's bounds: pixel (i, j) sits at (xmin + i * dx, ymax - j * dy),
    as gsdf_tpu/render/image.py:62-67 computes them."""
    width, height = int(width), int(height)
    if width < 1 or height < 1:
        raise ValueError(f"empty image {width} x {height}")
    bb = tree.bounds()
    sz = bb.size()
    dx = _f32(sz[0]) / _f32(width)
    dy = _f32(sz[1]) / _f32(height)
    return _f32(bb.min[0]) + dx / _f32(2), _f32(bb.max[1]), dx, dy


def pixel_positions(tree, width: int, height: int, device) -> torch.Tensor:
    """(height, width, 2) float32 positions of the pixels, as numpy makes
    them in the JAX package (xmin + arange * dx, ymax - arange * dy: one
    float32 rounding per operation)."""
    xmin, ymax, dx, dy = (float(v) for v in pixel_grid(tree, width, height))
    xs = xmin + torch.arange(width, dtype=torch.float32, device=device) * dx
    ys = ymax - torch.arange(height, dtype=torch.float32, device=device) * dy
    return torch.stack([xs[None, :].expand(height, width), ys[:, None].expand(height, width)], -1)


def distance_field_plain(tree, width: int, height: int, device) -> torch.Tensor:
    """K2-2D's plain version: the torch node tree on the pixels' positions."""
    pts = pixel_positions(tree, width, height, device)
    return tree.distance(pts.reshape(-1, 2)).reshape(height, width)


# --- kernel wrappers -------------------------------------------------------
def evaluate_points(tree, pos: torch.Tensor, device, parametric: bool = False) -> torch.Tensor:
    """Distances (N,) f32 of `tree` at pos (N, tree.NDIM) f32, contiguous
    and on `device` (KP; KPp with parametric=True, through the library of
    the tree's structure). An empty batch launches nothing."""
    device = entry_device(device)
    if pos.ndim != 2:
        raise ValueError(f"expected (N,{tree.NDIM}) positions, got {tuple(pos.shape)}")
    n = pos.shape[0]
    check_out(pos, (n, tree.NDIM), torch.float32, device)
    if device.type == "cpu":
        return point_eval_plain(tree, pos)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n:
        build(tree, "point", parametric).launch("point_eval", device, pos.data_ptr(), n,
                                                out.data_ptr(), tree=tree)
    return out


def distance_field(tree, width: int, height: int, device) -> torch.Tensor:
    """Distances (height, width) f32 of the 2D `tree` on the pixel grid
    over its bounds, row 0 at the top (K2-2D): one launch, no positions
    array."""
    if not isinstance(tree, Shader2D):
        raise TypeError(f"expected Shader2D, got {type(tree)}")
    device = entry_device(device)
    xmin, ymax, dx, dy = pixel_grid(tree, width, height)
    if device.type == "cpu":
        return distance_field_plain(tree, width, height, device)
    lib = build(tree, "field")
    out = torch.empty((int(height), int(width)), dtype=torch.float32, device=device)
    lib.launch("grid_eval_2d", device, out.data_ptr(), float(xmin), float(ymax), float(dx),
               float(dy), int(width), int(height))
    return out
