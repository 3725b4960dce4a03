"""Evaluation backends: batched SDF evaluation at arbitrary points
(torch counterpart of gsdf_tpu/eval/evaluator.py, the reference's gleval
package).

- `SDF3` / `SDF2` wrap a tree and a device. `evaluate` is host to host
  (numpy positions in, numpy distances out: one upload, one launch of
  the point kernel KP, one fetch); `evaluate_device` takes and returns
  tensors on the evaluator's device and never synchronises. On the CPU
  both run the plain torch tree.
- There is no jit cache and no batch bucket to port: the kernel is built
  once per tree (eval/point_kernels.py) and takes N as an argument.
- `evaluate_grid` (K2) makes its positions on the device, so a grid costs
  4 output bytes a point and no upload.
- `BlockCachedSDF3` and `CachedExactSDF3` are host-side numpy memo caches
  over any evaluator, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.node import Shader2D, Shader3D
from ..kernels import entry_device
from .grid_kernels import evaluate_grid  # noqa: F401  (re-exported)
from .point_kernels import evaluate_points

_f32 = np.float32


class _EvaluatorBase:
    """Shared logic for 2D/3D evaluator wrappers."""

    _ndim = 3

    def __init__(self, s, device=None):
        self.s = s
        self.device = entry_device(device)
        self._evaluations = 0
        # Construction-time smoke eval: catches broken distance
        # implementations early (reference gleval/cpu.go:26-31). On a CUDA
        # device it is also what builds the tree's point kernel.
        smoke = np.zeros((1, self._ndim), _f32)
        d = self.evaluate(smoke)
        if d.shape != (1,):
            raise ValueError(f"bad distance output shape {d.shape}")
        self._evaluations = 0

    def evaluations(self) -> int:
        """Total number of SDF point evaluations (reference gleval/cpu.go:126)."""
        return self._evaluations

    def bounds(self):
        return self.s.bounds()

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        """Evaluate distances at pos (N,ndim) float32, returning (N,) float32."""
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if pos.ndim != 2 or pos.shape[1] != self._ndim:
            raise ValueError(f"expected (N,{self._ndim}) positions, got {pos.shape}")
        n = pos.shape[0]
        if n == 0:
            return np.empty(0, _f32)
        out = self.evaluate_device(torch.from_numpy(pos).to(self.device))
        return out.cpu().numpy()

    def evaluate_device(self, pos: torch.Tensor) -> torch.Tensor:
        """Device-resident evaluation: pos is a float32 tensor (..., ndim)
        already on the evaluator's device; returns a tensor (...,) there
        without a host synchronisation."""
        if pos.ndim < 1 or pos.shape[-1] != self._ndim:
            raise ValueError(f"expected (...,{self._ndim}) positions, got {tuple(pos.shape)}")
        lead = pos.shape[:-1]
        flat = pos.reshape(-1, self._ndim).contiguous()
        out = evaluate_points(self.s, flat, self.device)
        self._evaluations += flat.shape[0]
        return out.reshape(lead)


class SDF3(_EvaluatorBase):
    """Batched 3D SDF evaluator (replaces gleval.SDF3, gleval/gleval.go:15)."""

    _ndim = 3

    def __init__(self, s: Shader3D, device=None):
        if not isinstance(s, Shader3D):
            raise TypeError(f"expected Shader3D, got {type(s)}")
        super().__init__(s, device)


class SDF2(_EvaluatorBase):
    """Batched 2D SDF evaluator (replaces gleval.SDF2, gleval/gleval.go:28)."""

    _ndim = 2

    def __init__(self, s: Shader2D, device=None):
        if not isinstance(s, Shader2D):
            raise TypeError(f"expected Shader2D, got {type(s)}")
        super().__init__(s, device)


def new_cpu_sdf3(s: Shader3D) -> SDF3:
    """Oracle evaluator pinned to host CPU (parity tests run against this)."""
    return SDF3(s, device="cpu")


def new_sdf3(s: Shader3D, device=None) -> SDF3:
    return SDF3(s, device)


def new_sdf2(s: Shader2D, device=None) -> SDF2:
    return SDF2(s, device)


def normals_central_diff(
    sdf: SDF3, pos: np.ndarray, step: float, userdata=None
) -> np.ndarray:
    """Central-difference normals, NOT normalized
    (reference gleval/gleval.go:53-108).

    Six evaluations of `sdf`. Where it evaluates on a device
    (`evaluate_device`: an SDF3), pos goes up once, pos +- h are the same
    float32 sums made there, and the normals come back in one fetch: bit
    for bit the result of six host-to-host `evaluate` calls, which is the
    form any other evaluator (a cache) gets."""
    step = _f32(step) * _f32(0.5)
    if step <= 0:
        raise ValueError("invalid step")
    pos = np.ascontiguousarray(pos, dtype=_f32)
    offsets = np.eye(3, dtype=_f32) * step
    if hasattr(sdf, "evaluate_device"):
        p = torch.from_numpy(pos).to(sdf.device)
        normals = torch.empty_like(p)
        for dim, h in enumerate(torch.from_numpy(offsets).to(sdf.device)):
            normals[:, dim] = sdf.evaluate_device(p + h) - sdf.evaluate_device(p - h)
        return normals.cpu().numpy()
    normals = np.empty_like(pos)
    for dim, h in enumerate(offsets):
        normals[:, dim] = sdf.evaluate(pos + h) - sdf.evaluate(pos - h)
    return normals


class BlockCachedSDF3:
    """Voxel-quantized memo cache wrapping any SDF3
    (reference gleval/gleval.go:110-217).

    Fully vectorized: voxel keys bit-pack into one int64, lookups are a
    single np.searchsorted over the sorted known-key array, and merges
    are one sort per batch — render-scale batches (millions of points)
    cost O(n log n) numpy, never a Python per-point loop."""

    _BIAS = 1 << 20  # 21-bit signed voxel coordinates per axis

    def __init__(self, sdf: SDF3, res_x: float, res_y: float, res_z: float):
        if res_x <= 0 or res_y <= 0 or res_z <= 0:
            raise ValueError("invalid resolution for BlockCachedSDF3")
        self.sdf = sdf
        self.mul = (1.0 / np.array([res_x, res_y, res_z], _f32)).astype(_f32)
        self._keys = np.empty(0, np.int64)  # sorted packed voxel keys
        self._vals = np.empty(0, _f32)
        self._hits = 0
        self._evals = 0

    def cache_hits(self) -> int:
        return self._hits

    def evaluations(self) -> int:
        return self._evals

    def bounds(self):
        return self.sdf.bounds()

    def _pack(self, pos: np.ndarray):
        """(packed int64 keys, valid mask). Coordinates outside the
        21-bit-per-axis key space (bounds spanning > 2^21 voxels, or
        points > 2^20 voxels below bb.min) would bleed into the
        neighboring axis fields and COLLIDE — the reference's
        map[[3]int] (gleval.go:110) cannot, so such rows bypass the
        cache entirely (always evaluate, never stored) instead of
        risking a wrong cached distance."""
        bb = self.sdf.bounds()
        k = ((pos - bb.min) * self.mul).astype(np.int64) + self._BIAS
        valid = np.all((k >= 0) & (k < (1 << 21)), axis=1)
        return k[:, 0] | (k[:, 1] << 21) | (k[:, 2] << 42), valid

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if len(pos) == 0:
            raise ValueError("empty buffers")
        packed, valid = self._pack(pos)
        dist = np.empty(len(pos), _f32)
        if len(self._keys):
            at = np.searchsorted(self._keys, packed)
            at_c = np.minimum(at, len(self._keys) - 1)
            hit = (self._keys[at_c] == packed) & valid
            dist[hit] = self._vals[at_c[hit]]
        else:
            hit = np.zeros(len(pos), bool)
        miss = ~hit
        n_miss = int(miss.sum())
        if n_miss:
            d_new = np.asarray(self.sdf.evaluate(pos[miss]), _f32)
            dist[miss] = d_new
            # store one value per voxel, last writer wins (the reference
            # loop stores in order, gleval.go:188-199); out-of-key-space
            # rows are never stored
            vm = valid[miss]
            pm = packed[miss][vm]
            dn = d_new[vm]
            if len(pm):
                rev_first = np.unique(pm[::-1], return_index=True)[1]
                uk, uv = pm[::-1][rev_first], dn[::-1][rev_first]
                keys = np.concatenate([self._keys, uk])
                vals = np.concatenate([self._vals, uv])
                order = np.argsort(keys, kind="stable")
                self._keys, self._vals = keys[order], vals[order]
        self._evals += len(pos)
        self._hits += len(pos) - n_miss
        return dist


class CachedExactSDF3:
    """Exact-position memo cache: hits only on bit-identical (x,y,z)
    float32 positions (reference cachedExactSDF3, gleval/gleval.go:220-292
    — keys are Float32bits of each coordinate). Debug/analysis tool for
    measuring how often a renderer re-evaluates the same point; unlike
    BlockCachedSDF3 a hit is always numerically exact, never quantized.

    Vectorized like BlockCachedSDF3: the three u32 bit patterns form a
    structured key (lexicographic compare), lookups are one searchsorted
    over the sorted known-key array per batch."""

    _DT = np.dtype([("x", "u4"), ("y", "u4"), ("z", "u4")])

    def __init__(self, sdf: SDF3):
        self.sdf = sdf
        self._keys = np.empty(0, self._DT)  # sorted packed bit-keys
        self._vals = np.empty(0, _f32)
        self._hits = 0
        self._evals = 0

    def cache_hits(self) -> int:
        return self._hits

    def evaluations(self) -> int:
        return self._evals

    def bounds(self):
        return self.sdf.bounds()

    def _pack(self, pos: np.ndarray) -> np.ndarray:
        bits = np.ascontiguousarray(pos, dtype=_f32).view(np.uint32)
        return bits.reshape(-1, 3).copy().view(self._DT).reshape(-1)

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if len(pos) == 0:
            raise ValueError("empty buffers")
        packed = self._pack(pos)
        dist = np.empty(len(pos), _f32)
        if len(self._keys):
            at = np.searchsorted(self._keys, packed)
            at_c = np.minimum(at, len(self._keys) - 1)
            hit = self._keys[at_c] == packed
            dist[hit] = self._vals[at_c[hit]]
        else:
            hit = np.zeros(len(pos), bool)
        miss = ~hit
        n_miss = int(miss.sum())
        if n_miss:
            pm = packed[miss]
            # the reference does a FULL lookup pass over the batch before
            # evaluating any miss (gleval.go:241-266), so in-batch
            # duplicates of a new position are ALL misses: every duplicate
            # row is re-evaluated and the last store wins
            # (gleval.go:268-287). hits += len(pos) - len(seekPos).
            d_new = np.asarray(self.sdf.evaluate(pos[miss]), _f32)
            dist[miss] = d_new
            rev_first = np.unique(pm[::-1], return_index=True)[1]
            uk, uv = pm[::-1][rev_first], d_new[::-1][rev_first]
            keys = np.concatenate([self._keys, uk])
            vals = np.concatenate([self._vals, uv])
            order = np.argsort(keys, kind="stable")
            self._keys, self._vals = keys[order], vals[order]
        self._evals += len(pos)
        self._hits += len(pos) - n_miss
        return dist
