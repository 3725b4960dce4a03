"""Specialized whole-kernel 2D evaluators (reference gleval/gpu.go:169-446:
PolygonGPU, Lines2DGPU, DisplaceMulti2D; torch counterpart of
gsdf_tpu/eval/special.py).

In the reference these hand-written compute shaders bypass tree codegen to
benchmark raw GPU throughput. Here every node already compiles into the
tree's point kernel, so these are thin constructors over the corresponding
nodes, retained for API parity and as microbenchmark entry points.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..core import Builder
from ..core.ops2 import TranslateMulti2D
from ..core.primitives2 import Lines2D, Polygon2D
from ..kernels import entry_device
from .evaluator import SDF2, new_sdf2, new_sdf3
from .grid_kernels import evaluate_grid

_f32 = np.float32


def polygon_gpu(vertices, device=None) -> SDF2:
    """Winding-number polygon evaluator (reference PolygonGPU, gpu.go:169)."""
    return new_sdf2(Polygon2D(np.asarray(vertices, _f32)), device)


def lines2d_gpu(segments, width, device=None) -> SDF2:
    """Batched thick-segment evaluator (reference Lines2DGPU, gpu.go:256)."""
    return new_sdf2(Lines2D(np.asarray(segments, _f32), width), device)


def displace_multi2d(shape2d, displacements, device=None) -> SDF2:
    """Multi-displacement min-union evaluator
    (reference DisplaceMulti2D, gpu.go:355)."""
    return new_sdf2(TranslateMulti2D(shape2d, displacements), device)


def throughput(sdf, n_points: int = 1 << 20, repeats: int = 5, seed: int = 1):
    """Measure raw evaluation throughput of an SDF2/SDF3, the reference's
    reason for having these special evaluators (it benchmarks PolygonGPU
    et al. in examples/test/glsdf3test.go:55-66).

    Returns (evals_per_second, median_ms). End-to-end wall time of
    `evaluate`, host to host: the upload, the kernel and the fetch, which
    is the completion barrier (a launch alone returns before the card has
    finished)."""
    rng = np.random.default_rng(seed)
    bb = sdf.bounds()
    lo = np.asarray(bb.min, _f32)
    hi = np.asarray(bb.max, _f32)
    pts = rng.uniform(0.0, 1.0, (n_points, len(lo.reshape(-1)))).astype(_f32)
    pts = lo + pts * (hi - lo)
    sdf.evaluate(pts)  # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.monotonic()
        d = np.asarray(sdf.evaluate(pts))
        times.append(time.monotonic() - t0)
        if not np.isfinite(d).all():
            raise RuntimeError("non-finite distances in a throughput run")
    med = statistics.median(times)
    return n_points / med, med * 1e3


def throughput_grid(tree, shape=(256, 256, 256), repeats: int = 5, device=None):
    """On-device evaluation throughput: the grid kernel K2 (positions made
    on the device), a torch reduction of |clip(d, -1, 1)| and ONE scalar
    fetched, which is the completion barrier: it measures the card, not
    the host link (`throughput` measures the end-to-end path). Returns
    (evals_per_second, median_ms)."""
    device = entry_device(device)
    nk, nj, ni = (int(x) for x in shape)
    bb = tree.bounds().scale_centered((1.01, 1.01, 1.01))
    res = _f32(max(bb.size()) / max(nk - 1, 1))
    origin = np.asarray(bb.min, _f32)

    def checksum() -> float:
        d = evaluate_grid(tree, origin, res, (nk, nj, ni), device)
        return float(torch.sum(torch.abs(torch.clamp(d, -1.0, 1.0))))

    checksum()  # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.monotonic()
        checksum()
        times.append(time.monotonic() - t0)
    med = statistics.median(times)
    return nk * nj * ni / med, med * 1e3


def benchmark_trees() -> dict:
    """name -> tree of `run_benchmarks`' battery, at the reference's sizes
    (glsdf3test.go:55-66): a 64-vertex polygon, 128 thick segments and 128
    displacements of a circle, made from a fixed seed, and a deep 3D CSG
    tree."""
    bld = Builder()
    rng = np.random.default_rng(7)
    poly = rng.uniform(-1, 1, (64, 2)).astype(_f32)
    segs = rng.uniform(-1, 1, (128, 2, 2)).astype(_f32)
    disp = rng.uniform(-1, 1, (128, 2)).astype(_f32)
    deep = bld.difference(
        bld.smooth_union(0.2, bld.new_sphere(0.8), bld.new_box(1, 1, 1, 0.05)),
        bld.new_cylinder(0.3, 3.0, 0.0),
    )
    return {
        "polygon_gpu(64v)": Polygon2D(poly),
        "lines2d_gpu(128s)": Lines2D(segs, 0.05),
        "displace_multi2d(128d)": TranslateMulti2D(bld.new_circle(0.1), disp),
        "deep_tree_3d": deep,
    }


def run_benchmarks(n_points: int = 1 << 20, device=None, log=print):
    """The reference's special-evaluator benchmark battery
    (glsdf3test.go:55-66): host-to-host throughput of the three special
    evaluators and of a deep CSG tree through the same point kernel, then
    the deep tree's on-device grid throughput. Returns
    {name: evals_per_second}."""
    trees = benchmark_trees()
    out = {}
    for name, tree in trees.items():
        sdf = new_sdf3(tree, device) if tree.NDIM == 3 else new_sdf2(tree, device)
        eps, ms = throughput(sdf, n_points)
        out[name] = eps
        log(
            f"[{ms:8.2f}ms] {name}: {eps/1e9:.3f} Geval/s end-to-end "
            f"({n_points} host pts incl. link transfer)"
        )
    eps, ms = throughput_grid(trees["deep_tree_3d"], (256, 256, 256), device=device)
    out["deep_tree_3d_grid_on_device"] = eps
    log(
        f"[{ms:8.2f}ms] deep_tree_3d 256^3 on-device: {eps/1e9:.2f} Geval/s "
        "(chip throughput, checksum fetch)"
    )
    return out
