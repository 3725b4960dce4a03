"""Evaluation backends (point-batch + grid evaluators, normals, caches)."""
from .batch import Batcher, BatcherConfig
from .evaluator import (
    SDF2,
    SDF3,
    BlockCachedSDF3,
    CachedExactSDF3,
    evaluate_grid,
    new_cpu_sdf3,
    new_sdf2,
    new_sdf3,
    normals_central_diff,
)
from .special import displace_multi2d, lines2d_gpu, polygon_gpu

__all__ = [
    "Batcher",
    "BatcherConfig",
    "SDF2",
    "SDF3",
    "BlockCachedSDF3",
    "CachedExactSDF3",
    "displace_multi2d",
    "evaluate_grid",
    "lines2d_gpu",
    "new_cpu_sdf3",
    "new_sdf2",
    "new_sdf3",
    "normals_central_diff",
    "polygon_gpu",
]
