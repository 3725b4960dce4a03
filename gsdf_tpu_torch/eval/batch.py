"""Batcher: elementwise binary operations on distance buffers
(reference gleval/batchevaluator.go:13-57 + gpu_cgo.go:18-73; torch
counterpart of gsdf_tpu/eval/batch.py).

The reference compiles a one-off GLSL compute shader per operation; the
JAX package jits `jnp.minimum` and the like, outside any hand-written
kernel. Here each operation is the matching torch call on the Batcher's
device, host buffers in and out. A custom operation is a callable over
torch tensors; nothing is compiled per operation, so the JAX package's
cache of 256 jitted callables has no counterpart.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels import entry_device


class BatcherConfig:
    """(reference batchevaluator.go:9)."""

    def __init__(self, device=None):
        self.device = device


class Batcher:
    """Elementwise binary ops over distance buffers."""

    def __init__(self, cfg: BatcherConfig | None = None):
        cfg = cfg or BatcherConfig()
        self.device = entry_device(cfg.device)

    def _run(self, fn, dst, a, b):
        ta = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        tb = torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
        out = fn(ta, tb).cpu().numpy()
        if dst is None:
            return out
        dst[:] = out
        return dst

    def union(self, dst, a, b):
        """dst = min(a, b) (reference runUnion, gpu_cgo.go:18)."""
        return self._run(torch.minimum, dst, a, b)

    def diff(self, dst, a, b):
        """dst = max(a, -b) (reference runDiff)."""
        return self._run(lambda x, y: torch.maximum(x, -y), dst, a, b)

    def intersect(self, dst, a, b):
        """dst = max(a, b) (reference runIntersect)."""
        return self._run(torch.maximum, dst, a, b)

    def execute_raw_binary_operation(self, op: Callable, dst, a, b):
        """Arbitrary elementwise op(a, b) -> d over distance buffers
        (reference ExecuteRawBinaryOperation, batchevaluator.go:13; the
        GLSL expression string becomes a callable over torch tensors)."""
        return self._run(op, dst, a, b)
