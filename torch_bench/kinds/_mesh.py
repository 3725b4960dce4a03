"""What the mesh kinds (`export`, `edit`) share: the STL sink, the soup a
reference mesh is compared as, and the bound of a compact render's work."""
from __future__ import annotations

import math

import numpy as np
import torch

from torch_bench import bounds

_f32 = np.float32
#: STL record layout: normal, three vertices (float32 x 3 each), 2 B attribute
STL_RECORD = np.dtype([("normal", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])


def node(root, path):
    for name in path:
        root = getattr(root, name)
    return root


def soup_gap(tris: np.ndarray, ref: torch.Tensor, res) -> float:
    """The largest distance, in cubes, between a vertex of triangle i and the
    same vertex of the reference's triangle i, over the triangles both have
    (a triangle missing or extra shifts every later one)."""
    n = min(len(tris), len(ref))
    if n == 0:
        return 0.0 if len(tris) == len(ref) else math.inf
    return float(np.abs(tris[:n] - ref[:n].cpu().numpy()).max() / _f32(res))


class Chunks:
    """The sink an export writes its STL into: it keeps the bytes objects it
    is given, so the STL is in hand without the copy a BytesIO would add
    (21 MB an export at flange 400, the harness's cost, not the program's)."""

    def __init__(self):
        self.parts: list = []

    def write(self, b) -> int:
        self.parts.append(b)
        return len(b)

    def nbytes(self) -> int:
        return sum(len(b) for b in self.parts)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def soup_answer(tris: np.ndarray) -> dict:
    """A mesh answer made of a (T, 3, 3) soup: one vertex per corner, and
    its binary STL (normals from the winding, as the STL writer makes
    them)."""
    tris = np.ascontiguousarray(tris, _f32)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2).astype(_f32)
    length = np.sqrt((n * n).sum(axis=1, dtype=_f32))
    with np.errstate(divide="ignore", invalid="ignore"):
        n = np.where(length[:, None] > 0, n / length[:, None], n).astype(_f32)
    rec = np.zeros(len(tris), STL_RECORD)
    rec["normal"], rec["v"] = n, tris
    stl = Chunks()
    stl.write(bytes(80) + np.uint32(len(tris)).tobytes())
    stl.write(rec.tobytes())
    return {"verts": tris.reshape(-1, 3), "tri_idx": np.arange(3 * len(tris), dtype=np.int32)
            .reshape(-1, 3), "stl": stl}


def render_bound_s(config: dict, work: dict, completed: int, params: int = 0):
    """The bound of `completed` compact renders of the configuration's grid,
    with the reference's active cubes and crossing edges (`work`)."""
    if "active" not in work:
        return None
    nx, ny, nz = config["cubes"]
    one = bounds.mesh_bound_s(int(config["corners"]), nx * ny * nz, work["active"],
                              work["n_t"], int(config["ops_per_point"]), params)
    return one * completed
