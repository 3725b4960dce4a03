"""Indexed mesh export: OBJ and binary PLY (gsdf_tpu/render/mesh_export.py,
copied: the JAX package's module is jax-free, but importing it would
load JAX through gsdf_tpu/__init__).

Triangle soup is welded into an indexed mesh by the native layer
(native.weld); these formats are additions over the reference, which
only writes STL.
"""
from __future__ import annotations

import numpy as np

from ..native import weld


def write_obj_indexed(w, verts: np.ndarray, tri_idx: np.ndarray) -> None:
    """Write Wavefront OBJ (text) of an indexed mesh. w is a text-mode file."""
    lines = [f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}" for v in np.asarray(verts)]
    lines += [f"f {f[0]} {f[1]} {f[2]}" for f in np.asarray(tri_idx) + 1]  # 1-indexed
    w.write("\n".join(lines))
    w.write("\n")


def write_ply_indexed(w, verts: np.ndarray, tri_idx: np.ndarray) -> None:
    """Write binary little-endian PLY of an indexed mesh. w is a binary-mode file."""
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tri_idx)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    w.write(header.encode())
    w.write(np.ascontiguousarray(verts, "<f4").tobytes())
    face = np.empty(len(tri_idx), dtype=[("n", "u1"), ("i", "<i4", 3)])
    face["n"] = 3
    face["i"] = tri_idx
    w.write(face.tobytes())


def write_obj(w, tris: np.ndarray, weld_tol: float = 0.0) -> None:
    """Write a triangle soup as OBJ, welded first."""
    write_obj_indexed(w, *weld(tris, weld_tol))


def write_ply(w, tris: np.ndarray, weld_tol: float = 0.0) -> None:
    """Write a triangle soup as binary PLY, welded first."""
    write_ply_indexed(w, *weld(tris, weld_tol))


def write_obj_file(path: str, tris: np.ndarray, weld_tol: float = 0.0) -> None:
    with open(path, "w") as f:
        write_obj(f, tris, weld_tol)


def write_ply_file(path: str, tris: np.ndarray, weld_tol: float = 0.0) -> None:
    with open(path, "wb") as f:
        write_ply(f, tris, weld_tol)


def write_obj_indexed_file(path: str, verts, tri_idx) -> None:
    with open(path, "w") as f:
        write_obj_indexed(f, verts, tri_idx)


def write_ply_indexed_file(path: str, verts, tri_idx) -> None:
    with open(path, "wb") as f:
        write_ply_indexed(f, verts, tri_idx)
