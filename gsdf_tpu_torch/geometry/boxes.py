"""Host-side axis-aligned bounding box algebra (float32 numpy).

TPU-native rebuild of the box math used by the reference CAD kernel
(soypat/geometry ms2.Box / ms3.Box as consumed by gsdf; see reference
usage in operations.go:56-800, glrender/flatrenderer.go:47).

These run at tree-construction time on the host, never per-evaluation,
so plain numpy float32 is the right tool (no jax tracing overhead).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_f32 = np.float32


def _v(x, n: int) -> np.ndarray:
    a = np.asarray(x, dtype=_f32).reshape(-1)
    if a.size == 1:
        a = np.full(n, a[0], dtype=_f32)
    if a.size != n:
        raise ValueError(f"expected {n} components, got {a.size}")
    return a


@dataclasses.dataclass(frozen=True)
class Box:
    """N-dimensional min/max box. Immutable; all ops return new boxes."""

    min: np.ndarray
    max: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "min", np.asarray(self.min, dtype=_f32))
        object.__setattr__(self, "max", np.asarray(self.max, dtype=_f32))
        if self.min.shape != self.max.shape:
            raise ValueError("box min/max shape mismatch")

    @property
    def ndim(self) -> int:
        return int(self.min.size)

    # --- constructors ------------------------------------------------
    @staticmethod
    def centered(center, size) -> "Box":
        c = np.asarray(center, dtype=_f32)
        s = np.asarray(size, dtype=_f32)
        return Box(c - s / 2, c + s / 2)

    @staticmethod
    def empty(ndim: int) -> "Box":
        return Box(np.zeros(ndim, _f32), np.zeros(ndim, _f32))

    # --- queries -----------------------------------------------------
    def size(self) -> np.ndarray:
        return (self.max - self.min).astype(_f32)

    def center(self) -> np.ndarray:
        return ((self.min + self.max) * _f32(0.5)).astype(_f32)

    def diagonal(self) -> float:
        """Diagonal length in float32 arithmetic (matching Go ms3.Norm's
        f32 sqrt-of-dot as used for resolution selection; the reference's
        printed flange resolution 0.21679485 reproduces bit-exactly)."""
        s = self.size().astype(_f32)
        acc = _f32(0)
        for c in s:
            acc = _f32(acc + _f32(c * c))
        return float(np.sqrt(acc, dtype=_f32))

    def vertices(self) -> np.ndarray:
        """All 2^n corner vertices, shape (2^n, n)."""
        n = self.ndim
        out = np.empty((1 << n, n), dtype=_f32)
        for i in range(1 << n):
            for d in range(n):
                out[i, d] = self.max[d] if (i >> d) & 1 else self.min[d]
        return out

    def contains(self, p) -> bool:
        p = np.asarray(p, dtype=_f32)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def is_empty(self) -> bool:
        return bool(np.any(self.max <= self.min))

    # --- algebra -----------------------------------------------------
    def union(self, other: "Box") -> "Box":
        return Box(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def intersect(self, other: "Box") -> "Box":
        return Box(np.maximum(self.min, other.min), np.minimum(self.max, other.max))

    def add(self, offset) -> "Box":
        off = _v(offset, self.ndim)
        return Box(self.min + off, self.max + off)

    def scale(self, factors) -> "Box":
        f = _v(factors, self.ndim)
        return Box(self.min * f, self.max * f).canon()

    def scale_centered(self, factors) -> "Box":
        f = _v(factors, self.ndim)
        c = self.center()
        return Box((self.min - c) * f + c, (self.max - c) * f + c)

    def include_point(self, p) -> "Box":
        p = _v(p, self.ndim)
        return Box(np.minimum(self.min, p), np.maximum(self.max, p))

    def canon(self) -> "Box":
        return Box(np.minimum(self.min, self.max), np.maximum(self.min, self.max))

    def pad(self, amount) -> "Box":
        a = _v(amount, self.ndim)
        return Box(self.min - a, self.max + a)

    def __repr__(self):
        return f"Box(min={self.min.tolist()}, max={self.max.tolist()})"


def box2(xmin, ymin, xmax, ymax) -> Box:
    return Box(np.array([xmin, ymin], _f32), np.array([xmax, ymax], _f32))


def box3(xmin, ymin, zmin, xmax, ymax, zmax) -> Box:
    return Box(np.array([xmin, ymin, zmin], _f32), np.array([xmax, ymax, zmax], _f32))


def centered_box2(size_x, size_y) -> Box:
    return Box.centered(np.zeros(2, _f32), np.array([size_x, size_y], _f32))


def centered_box3(size_x, size_y, size_z) -> Box:
    return Box.centered(np.zeros(3, _f32), np.array([size_x, size_y, size_z], _f32))


# --- rotation / transform matrices (host-side, float32) --------------

def rotation_mat2(theta: float) -> np.ndarray:
    c, s = np.cos(_f32(theta)), np.sin(_f32(theta))
    return np.array([[c, -s], [s, c]], dtype=_f32)


def rotation_mat4(radians: float, axis) -> np.ndarray:
    """4x4 homogeneous rotation about an arbitrary axis through the origin.

    Mirrors the rotation convention of the reference (ms3.RotationMat4 as
    used by operations.go:394-400): right-handed rotation by `radians`
    about `axis`.
    """
    a = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(a)
    if n == 0:
        raise ValueError("null rotation axis")
    x, y, z = a / n
    s, c = np.sin(float(radians)), np.cos(float(radians))
    m = 1.0 - c
    rot = np.array(
        [
            [m * x * x + c, m * x * y - z * s, m * z * x + y * s, 0],
            [m * x * y + z * s, m * y * y + c, m * y * z - x * s, 0],
            [m * z * x - y * s, m * y * z + x * s, m * z * z + c, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return rot.astype(_f32)


def translation_mat4(v) -> np.ndarray:
    m = np.eye(4, dtype=_f32)
    m[:3, 3] = _v(v, 3)
    return m


def mul_box3(mat4: np.ndarray, box: Box) -> Box:
    """Transform a 3D box by a 4x4 matrix, returning the AABB of the result."""
    verts = box.vertices()  # (8,3)
    hom = np.concatenate([verts, np.ones((8, 1), _f32)], axis=1)
    out = (mat4 @ hom.T).T[:, :3]
    return Box(out.min(axis=0).astype(_f32), out.max(axis=0).astype(_f32))
