"""Each kernel's bound: the least time the card could take for its work.
A measurement tool of chip_smoke.py, beside it: no path of the program
(gsdf_tpu_torch) needs it.

    bound = max(ops / PEAK_OPS, bytes / HBM_BYTES_PER_S)

- **Bytes** count each input byte read once and each output byte written
  once (`kernel_bytes`), from this run's shapes and counts: a kernel that
  reads a byte twice or keeps scratch of its own pays that above its bound.
- **Ops** are the elementwise floating-point operations of the kernel's
  plain torch version, counted by `OpCounter` (a TorchDispatchMode; for
  K5, its plain version on the run's grid, which does K5's work and no
  more: the tree at every corner and 6 times at every active edge, t, flip
  and the normal at every active edge, a QEF row where an edge is active,
  a solve at every live voxel): each
  arithmetic aten op whose inputs or output are floating point adds its
  output's numel (a reduction: the elements it folds away). Casts, views,
  indexing and fills count nothing, so `core.mathx._rounded`'s float64
  detour counts as the one float32 op it stands for. For the tree
  (K1, K2) `tree_ops_per_point` counts the plain tree on seeded points on
  the CPU; the card's kernel evaluates the same expression (KP and K2-2D
  too, on 2D trees as well).
- **K8** (the raymarcher) counts what the kernel does, which depends on
  the data: each ray stops when it is done, so its ops are `raymarch_ops`
  from this run's evaluation count (K8 returns each ray's, and so does
  its plain version): evaluations x the tree's operations per point, plus
  each march step's own arithmetic and each ray's direction and shading.
- **PEAK_OPS** is half the H100 SXM's published 67 TFLOP/s float32: that
  peak counts a fused multiply-add as two operations, and the kernels are
  built with -fmad=false (the golden counts need it), so every operation
  issues alone. `PUBLISHED_FP32` is kept for the share against the data
  sheet's figure.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: H100 SXM HBM3, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 outside the tensor cores, NVIDIA's data sheet (FMA = 2)
PUBLISHED_FP32 = 67e12
#: one operation per issue slot: the kernels contract no multiply-add
PEAK_OPS = PUBLISHED_FP32 / 2

#: elementwise aten ops counted as one operation per output element
ELEMENTWISE = frozenset(
    """add sub rsub mul div true_divide neg abs sign sgn sqrt rsqrt reciprocal
    atan2 atan asin acos sin cos tan exp log pow floor ceil round trunc frac
    remainder fmod minimum maximum fmin fmax clamp clamp_min clamp_max where
    lt le gt ge eq ne isinf isnan logical_and logical_or logical_not""".split()
)
#: reductions, counted as the elements they fold away
REDUCTIONS = frozenset("sum amax amin max min prod".split())


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class OpCounter(TorchDispatchMode):
    """Counts the elementwise floating-point operations run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ELEMENTWISE or name in REDUCTIONS:
            flat = list(args) + list((kwargs or {}).values())
            res = out[0] if isinstance(out, tuple) else out
            binary = len(args) > 1 and isinstance(args[1], torch.Tensor)  # max(a, b)
            if isinstance(res, torch.Tensor) and (_is_float(res) or any(map(_is_float, flat))):
                if name in ELEMENTWISE or binary:
                    self.ops += res.numel()
                else:
                    self.ops += args[0].numel() - res.numel()
        return out


def count_ops(fn, *args, **kwargs) -> tuple:
    """(fn's result, the floating-point operations it ran)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.ops


def tree_ops_per_point(tree, n: int = 256, seed: int = 0) -> int:
    """The tree's floating-point operations per evaluated point: the plain
    torch tree on 2n and on n seeded points in its bounds (CPU, float32);
    the difference over n, so work on constants (per call, not per point)
    drops out."""
    bb = tree.bounds()
    lo, hi = np.asarray(bb.min, np.float32), np.asarray(bb.max, np.float32)
    pts = np.random.default_rng(seed).uniform(lo, hi, (2 * n, tree.NDIM)).astype(np.float32)
    p = torch.from_numpy(pts)
    _, ops2 = count_ops(tree.distance, p)
    _, ops1 = count_ops(tree.distance, p[:n].contiguous())
    per, rest = divmod(ops2 - ops1, n)
    if rest:
        raise RuntimeError(f"the tree's operation count is not linear in points: {ops2 - ops1} / {n}")
    return per


def kernel_bytes(name: str, *, corners=0, cubes=0, active=0, n_t=0, tris=0, verts=0,
                 points=0, ndim=3, pixels=0, n_params=0, edges=0, voxels=0, tiles=0) -> int:
    """Bytes a kernel must move: each input read once, each output written
    once, from this run's shapes and counts.

    - grid_eval (K2): writes 4 B per corner;
    - point_eval (KP): reads 4 * ndim B per point, writes 4 B per point;
    - grid_eval_2d (K2-2D): writes 4 B per pixel;
    - classified_grid (K1): writes 4 B per corner and 1 B per cube;
    - classified_grid_param, point_eval_param (K1p, KPp): K1's and KP's
      bytes and the 4 B per parameter that the launch carries (the
      operations are the baked form's);
    - compact_active (K3): reads 1 B per cube, writes 4 B per active cube
      (ids), 16 B per 256 active cubes (the edge and triangle block
      offsets) and 24 B of counts; the edge-rank directory that only K7w
      asks for (4 B per 32 cubes) is not counted;
    - compact_emit (K4): reads per active cube its id, case byte and the
      4 distances it interpolates (corner 0 and its owner edges' far ends),
      K3's offsets; writes 1 B per active cube and 4 B per t;
    - emit_soup (K7s): reads per active cube its id, case byte and 8
      corner distances, K3's triangle offsets; writes 36 B per triangle;
      in tile mode it also reads the atlas's tile table, 12 B per tile;
    - emit_welded (K7w): reads per active cube its id and case byte and the
      4 owner-edge distances, K3's two offsets; writes 12 B per vertex and
      per triangle and the 4 B count. Its owner lookups (neighbours' case
      bytes, directory entries) are not counted: a kernel pays for them
      above its bound, as for any scratch;
    - dc_mesh (K5): writes 4 B (id) and 1 B (flip) per active edge and
      12 B per live voxel; its corner grid, ballot words, ranks, crossing
      points and normals are its own scratch. dc_mesh_param (K5p): also the
      4 B per parameter that each of its two calls carries;
    - tile_prune (K6c): writes 1 B per tile of the coarse grid and the 4 B
      count; tile_prune_param (K6cp) also the 4 B per parameter;
    - tile_atlas (K6a): reads the 12 B row of each of its `tiles`, writes
      4 B per atlas corner and 1 B per atlas cube (seam layers included);
      tile_atlas_param (K6ap) also the 4 B per parameter;
    - tile_global_ids: reads each active id and writes it as a global id
      (8 B), reads the tile table (12 B per tile);
    - raymarch (K8): writes 3 B per output pixel; the supersamples of an
      aa > 1 frame are its own scratch. raymarch_param (K8p) also the 4 B
      per parameter.
    """
    offsets = 8 * -(-active // 256)
    per = {
        "grid_eval": 4 * corners,
        "point_eval": (4 * ndim + 4) * points,
        "grid_eval_2d": 4 * pixels,
        "classified_grid": 4 * corners + cubes,
        "classified_grid_param": 4 * corners + cubes + 4 * n_params,
        "point_eval_param": (4 * ndim + 4) * points + 4 * n_params,
        "compact_active": cubes + 4 * active + 2 * offsets + 24,
        "compact_emit": (4 + 1 + 16 + 1) * active + offsets + 4 * n_t,
        "emit_soup": (4 + 1 + 32) * active + offsets + 36 * tris + 12 * tiles,
        "emit_welded": (4 + 1 + 16) * active + 2 * offsets + 12 * verts + 12 * tris + 4,
        "dc_mesh": 5 * edges + 12 * voxels,
        "dc_mesh_param": 5 * edges + 12 * voxels + 8 * n_params,
        "tile_prune": tiles + 4,
        "tile_prune_param": tiles + 4 + 4 * n_params,
        "tile_atlas": 4 * corners + cubes + 12 * tiles,
        "tile_atlas_param": 4 * corners + cubes + 12 * tiles + 4 * n_params,
        "tile_global_ids": 8 * active + 12 * tiles,
        "raymarch": 3 * pixels,
        "raymarch_param": 3 * pixels + 4 * n_params,
    }
    return int(per[name])


class _NoTree:
    """A stand-in tree whose distance is a view of the positions (no
    operation): what the raymarcher does besides the tree."""

    NDIM = 3

    @staticmethod
    def distance(p):
        return p[..., 0]


def _per_ray(fn, n: int = 64) -> int:
    """fn(n)'s operations per ray: fn on 2n rays less fn on n, over n."""
    _, ops2 = count_ops(fn, 2 * n)
    _, ops1 = count_ops(fn, n)
    per, rest = divmod(ops2 - ops1, n)
    if rest:
        raise RuntimeError(f"not linear in rays: {ops2 - ops1} / {n}")
    return per


def raymarch_ops(tree, evaluations: int, rays: int) -> int:
    """K8's floating-point operations on a frame of `rays` supersamples
    that made `evaluations` tree evaluations in all (the march's, and 5 a
    ray after it): evaluations x tree_ops_per_point, the march steps' own
    arithmetic (position, the scene's scale and offset, the hit and far
    tests, the move of t) and each ray's direction and shading, counted by
    OpCounter over the plain version's pieces (eval/ray_kernels.py) with
    the tree's work taken out."""
    from gsdf_tpu_torch.eval import ray_kernels as rk

    cam = rk.pack_camera([0, 0, 2], [1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 0],
                         [0, 0, 1], 1, 6)
    c = rk.frame_consts(cam, 0.8, "cpu")

    def along(n):
        rd = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3)
        return rd, torch.full((n,), 0.5)

    step = _per_ray(lambda n: rk.march_step(_NoTree, c, *along(n)))
    ray = _per_ray(lambda n: rk.rays(c, n, 1, "cpu"))
    shade = _per_ray(lambda n: rk.shade(_NoTree, c, *along(n)))
    march = evaluations - 5 * rays
    return int(evaluations * tree_ops_per_point(tree) + march * step + rays * (ray + shade))


def bound(ops: int, nbytes: int) -> dict:
    """The bound in ms and the limit that sets it ("operations" or
    "bytes"), with both times."""
    ops_ms = ops / PEAK_OPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "ops": int(ops),
        "bytes": int(nbytes),
        "ops_ms": ops_ms,
        "bytes_ms": bytes_ms,
        "published_fp32_ms": ops / PUBLISHED_FP32 * 1e3,
    }
