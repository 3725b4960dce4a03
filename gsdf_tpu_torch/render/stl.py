"""Binary STL output of the ported slice (gsdf_tpu/render/stl.py)."""
from __future__ import annotations

import struct

import numpy as np


def stl_header(n_triangles: int) -> bytes:
    """84-byte binary STL header (80 zero bytes + u32 triangle count)."""
    if n_triangles > 0xFFFFFFFF:
        raise ValueError("amount of triangles in model exceeds STL design limits")
    return bytes(80) + struct.pack("<I", int(n_triangles))


def write_binary_stl_indexed(w, verts: np.ndarray, tri_idx: np.ndarray) -> int:
    """Write an indexed mesh as binary STL without materializing the
    triangle soup (native gather+encode pass). Returns bytes written."""
    from ..native import stl_encode_indexed

    if len(tri_idx) == 0:
        raise ValueError("empty triangle slice")
    n = w.write(stl_header(len(tri_idx)))
    n += w.write(stl_encode_indexed(verts, tri_idx))
    return n
