"""Binary STL I/O (gsdf_tpu/render/stl.py; reference glrender/stl.go:
15-225), copied: the JAX package's module is jax-free, but importing it
would load JAX through gsdf_tpu/__init__. Record packing runs in the
native layer (native.stl_encode / stl_encode_indexed), with no fallback.
"""
from __future__ import annotations

import struct

import numpy as np

from ..native import STL_DTYPE as _STL_DTYPE
from ..native import stl_encode, stl_encode_indexed

_f32 = np.float32


def triangle_normals(tris: np.ndarray) -> np.ndarray:
    """Unit normals from vertex winding (cross(v2-v1, v3-v1), normalized)."""
    tris = np.asarray(tris, _f32)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (n / norm).astype(_f32)


def stl_header(n_triangles: int) -> bytes:
    """84-byte binary STL header (80 zero bytes + u32 triangle count)."""
    if n_triangles > 0xFFFFFFFF:
        raise ValueError("amount of triangles in model exceeds STL design limits")
    return bytes(80) + struct.pack("<I", int(n_triangles))


def write_binary_stl_indexed(w, verts: np.ndarray, tri_idx: np.ndarray) -> int:
    """Write an indexed mesh as binary STL without materializing the
    triangle soup (native gather+encode pass). Returns bytes written."""
    if len(tri_idx) == 0:
        raise ValueError("empty triangle slice")
    n = w.write(stl_header(len(tri_idx)))
    n += w.write(stl_encode_indexed(verts, tri_idx))
    return n


def write_binary_stl(w, model: np.ndarray) -> int:
    """Write (T,3,3) float32 triangles as binary STL. Returns bytes written."""
    model = np.asarray(model, _f32)
    if model.size == 0:
        raise ValueError("empty triangle slice")
    n = w.write(stl_header(model.shape[0]))
    n += w.write(stl_encode(model))
    return n


def write_stl_file(path: str, model: np.ndarray) -> int:
    with open(path, "wb") as f:
        return write_binary_stl(f, model)


def validate_stl_triangles(
    rec: np.ndarray, norm_tol: float = 5e-2, degenerate_tol: float = 1e-12
) -> dict:
    """Vectorized triangle validation (reference stlTriangle.validate,
    glrender/stl.go:129-149): finite check, degeneracy, stored-vs-computed
    normal agreement (either orientation). Returns violation counts."""
    tris = np.stack([rec["v1"], rec["v2"], rec["v3"]], axis=1).astype(_f32)
    finite = np.isfinite(tris).all(axis=(1, 2)) & np.isfinite(rec["normal"]).all(axis=1)
    calc = triangle_normals(tris * 10)  # reference scales by 10 (stl.go:156)
    area2 = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1)
    degenerate = area2 < degenerate_tol
    got = rec["normal"].astype(_f32)
    close = np.all(np.abs(calc - got) <= norm_tol, axis=1) | np.all(
        np.abs(-calc - got) <= norm_tol, axis=1
    )
    return {
        "nonfinite": int((~finite).sum()),
        "degenerate": int(degenerate.sum()),
        "normal_mismatches": int((~close & finite & ~degenerate).sum()),
    }


def read_binary_stl(r, validate: bool = False) -> np.ndarray:
    """Read binary STL (a path or a binary file), returning (T,3,3)
    float32 triangles (reference glrender/stl.go:175). With validate=True,
    raises if more than 10,000 stored normals disagree with computed
    normals (the reference's mismatch-abort threshold, stl.go:212)."""
    if isinstance(r, str):
        with open(r, "rb") as f:
            return read_binary_stl(f, validate)
    header = r.read(84)
    if len(header) < 84:
        raise ValueError("encountered EOF while reading STL header")
    (count,) = struct.unpack("<I", header[80:84])
    if count == 0:
        raise ValueError("STL header indicates 0 triangles present")
    data = r.read(count * 50)
    if len(data) < count * 50:
        raise ValueError(f"short STL body: {len(data)} < {count * 50}")
    rec = np.frombuffer(data, dtype=_STL_DTYPE, count=count)
    tris = np.stack([rec["v1"], rec["v2"], rec["v3"]], axis=1).astype(_f32)
    if np.any(~np.isfinite(tris)):
        raise ValueError("inf/NaN STL triangle vertex")
    if validate:
        stats = validate_stl_triangles(rec)
        if stats["normal_mismatches"] > 10_000:
            raise ValueError(
                f"got too many normal vector mismatches ({stats['normal_mismatches']})"
            )
    return tris
