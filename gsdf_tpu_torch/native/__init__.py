"""Host-side native runtime of the port, loaded with ctypes: the
compact-payload decoder (`gsdf_mc_decode`), the dual-contour quad
emission (`gsdf_dc_finish`), the STL encoders (soup and indexed), the STL
decoder and the soup welder.

The C++ source is the port's own: native.cpp beside this file, a copy
of the JAX package's gsdf_tpu/native/native.cpp (a test holds the two
files' bytes equal), compiled with the JAX package's flags
(gsdf_tpu/native/__init__.py:23-41) into the port's build directory. A
failed build raises; the port has no numpy fallback on its path.
The `*_plain` functions are numpy versions of the same, kept only for the
tests to hold the C++ against.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build, spans
from ..ops import mc_emit
from ..ops.mc_tables import MC_TRI_COUNT, MC_TRI_TABLE

_f32 = np.float32

NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cpp")
# deterministic f32: no FMA contraction, so vertex reconstruction matches
# the documented reference arithmetic
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off", "-pthread")

_P = ctypes.POINTER
_SIGNATURES = {
    "gsdf_mc_decode": (
        ctypes.c_int64,
        [
            _P(ctypes.c_uint32),  # ids
            _P(ctypes.c_uint8),  # cases
            ctypes.c_int64,  # n_active
            _P(ctypes.c_float),  # tvals
            ctypes.c_int64,  # n_verts
            ctypes.c_int32,  # nx
            ctypes.c_int32,  # ny
            ctypes.c_int32,  # nz
            _P(ctypes.c_float),  # origin[3]
            ctypes.c_float,  # res
            _P(ctypes.c_int8),  # tri_table
            _P(ctypes.c_uint8),  # tri_count
            _P(ctypes.c_uint8),  # edge_axis
            _P(ctypes.c_int8),  # edge_low
            _P(ctypes.c_float),  # verts_out
            _P(ctypes.c_int32),  # tri_idx_out
        ],
    ),
    "gsdf_stl_encode_indexed": (
        None,
        [_P(ctypes.c_float), _P(ctypes.c_int32), ctypes.c_int64, _P(ctypes.c_ubyte)],
    ),
    "gsdf_stl_encode": (None, [_P(ctypes.c_float), ctypes.c_int64, _P(ctypes.c_ubyte)]),
    "gsdf_stl_decode": (ctypes.c_int64, [_P(ctypes.c_ubyte), ctypes.c_int64, _P(ctypes.c_float)]),
    "gsdf_weld": (
        ctypes.c_int64,
        [_P(ctypes.c_float), ctypes.c_int64, ctypes.c_float, _P(ctypes.c_float),
         _P(ctypes.c_int32)],
    ),
    "gsdf_dc_finish": (
        ctypes.c_int64,
        [
            _P(ctypes.c_float),  # verts (n_vox, 3)
            _P(ctypes.c_int64),  # eax
            _P(ctypes.c_int64),  # lin
            _P(ctypes.c_uint8),  # flips
            ctypes.c_int64,  # n edges
            ctypes.c_int32,  # nx
            ctypes.c_int32,  # ny
            ctypes.c_int32,  # nz
            ctypes.c_int64,  # n_vox
            _P(ctypes.c_int32),  # offs (3,4,3)
            _P(ctypes.c_float),  # tris_out (2n,3,3)
            _P(ctypes.c_int64),  # blocks_out[6]
            ctypes.c_int32,  # force_sort
        ],
    ),
}

#: one binary STL record (reference glrender/stl.go:15-62): 50 bytes
STL_DTYPE = np.dtype(
    [("normal", "<f4", 3), ("v1", "<f4", 3), ("v2", "<f4", 3), ("v3", "<f4", 3),
     ("attr", "<u2")]
)

# decoder tables from the single canonical source (ops/mc_tables.py)
_TRI_TABLE = np.ascontiguousarray(MC_TRI_TABLE, np.int8)  # (256,5,3)
_TRI_COUNT = np.ascontiguousarray(MC_TRI_COUNT, np.uint8)  # (256,)
_EDGE_AXIS = np.ascontiguousarray(mc_emit.EDGE_AXIS, np.uint8)  # (12,)
_EDGE_LOW = np.ascontiguousarray(mc_emit.EDGE_LOW, np.int8)  # (12,3)

_lib = None


def get_lib() -> ctypes.CDLL:
    """The native library, built by g++ at first use."""
    global _lib
    if _lib is None:
        if not os.path.exists(NATIVE_SRC):
            raise RuntimeError(f"native source missing: {NATIVE_SRC}")
        with open(NATIVE_SRC, "rb") as f:
            key = _build.source_key(f.read(), *GXX_FLAGS)
        so = _build.build_shared(
            "gsdfnative", key,
            lambda out, d: ["g++", *GXX_FLAGS, "-o", out, NATIVE_SRC],
            timeout=300,
        )
        _lib = _build.load(so, _SIGNATURES)
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


def _crossing_bits(idx8):
    """Which of the 3 owner (low) edges cross, from the case byte's sign
    bits (bit k is the sign of corner k)."""
    b0 = idx8 & 1
    return np.stack(
        [b0 != ((idx8 >> 1) & 1), b0 != ((idx8 >> 3) & 1), b0 != ((idx8 >> 4) & 1)],
        axis=-1,
    )  # (A,3) bool


def mc_decode_plain(ids, cases, tvals, nx, ny, nz, origin, res):
    """Numpy decoder, the same output as gsdf_mc_decode (the JAX package's
    _mc_decode_numpy)."""
    ids = np.asarray(ids).astype(np.int64)
    if len(ids) and int(ids.max()) >= nx * ny * nz:
        raise ValueError("cube id outside decode space")
    idx8 = np.asarray(cases).astype(np.int32)
    A = len(ids)
    ci = (ids % nx).astype(np.int32)
    cj = ((ids // nx) % ny).astype(np.int32)
    ck = (ids // (nx * ny)).astype(np.int32)

    cross = _crossing_bits(idx8)  # (A,3)
    vbase = np.zeros(A + 1, np.int64)
    np.cumsum(cross.sum(axis=1), out=vbase[1:])
    n_verts = int(vbase[-1])
    if n_verts != len(tvals):
        raise ValueError("payload vertex count mismatch")

    # vertices: flat (cube-major, axis x,y,z) order matches the device's
    where = np.nonzero(cross.reshape(-1))[0]
    vcube = (where // 3).astype(np.int64)
    vaxis = (where % 3).astype(np.int64)
    res32 = _f32(res)
    origin = np.asarray(origin, _f32)
    pa = np.stack(
        [
            origin[0] + ci.astype(_f32) * res32,
            origin[1] + cj.astype(_f32) * res32,
            origin[2] + ck.astype(_f32) * res32,
        ],
        axis=-1,
    )  # (A,3) f32
    verts = pa[vcube].copy()
    paa = verts[np.arange(n_verts), vaxis]
    pb = (paa + res32).astype(_f32)
    t = np.asarray(tvals, _f32)
    interp = (paa + t * (pb - paa)).astype(_f32)
    verts[np.arange(n_verts), vaxis] = np.where(t == 1.0, pb, interp)

    # triangles: table walk vectorized over (A,5,3)
    tbl = _TRI_TABLE.astype(np.int32)[idx8]  # (A,5,3), -1 padded
    counts = _TRI_COUNT[idx8].astype(np.int32)  # (A,)
    e = np.maximum(tbl, 0)
    eax = _EDGE_AXIS.astype(np.int64)[e]  # (A,5,3)
    elow = _EDGE_LOW.astype(np.int64)[e]  # (A,5,3,3)
    oi = ci[:, None, None] + elow[..., 0]
    oj = cj[:, None, None] + elow[..., 1]
    ok = ck[:, None, None] + elow[..., 2]
    valid = np.arange(5, dtype=np.int32)[None, :] < counts[:, None]  # (A,5)
    oob = (oi >= nx) | (oj >= ny) | (ok >= nz)  # (A,5,3)
    if (oob & valid[:, :, None]).any():
        raise ValueError("owner cube outside decode space")
    oi, oj, ok = np.where(oob, 0, oi), np.where(oob, 0, oj), np.where(oob, 0, ok)
    owner_lin = (ok * ny + oj) * nx + oi  # (A,5,3)
    slot_map = np.full(nx * ny * nz, -1, np.int32)
    slot_map[ids] = np.arange(A, dtype=np.int32)
    oslot = slot_map[owner_lin]  # (A,5,3)
    if (oslot < 0)[valid].any():
        raise ValueError("unresolved owner cube (non-Lipschitz field?)")
    os_safe = np.maximum(oslot, 0)
    ocross = _crossing_bits(idx8[os_safe]).astype(np.int64)  # (A,5,3,3)
    rank = np.where(
        eax == 0, 0, np.where(eax == 1, ocross[..., 0], ocross[..., 0] + ocross[..., 1])
    )
    vid = vbase[os_safe] + rank  # (A,5,3)
    vid = vid[:, :, ::-1]  # reference winding (reversed triples)
    tri_idx = vid[valid].astype(np.int32)  # (T,3)
    return verts, tri_idx


def mc_decode(ids, cases, tvals, nx, ny, nz, origin, res):
    """Decode a compact-field payload into an indexed mesh with the native
    decoder. ids (A,) uint32 ascending active cube ids; cases (A,) uint8;
    tvals (V,) f32. Returns (verts (V,3) f32, tri_idx (T,3) i32). Raises
    ValueError when an owner reference is unresolvable."""
    ids = np.ascontiguousarray(ids, np.uint32)
    cases = np.ascontiguousarray(cases, np.uint8)
    tvals = np.ascontiguousarray(tvals, _f32)
    if ids.shape != cases.shape:
        raise ValueError("ids and cases differ in length")
    lib = get_lib()
    with spans.span("native.decode"):
        total = int(_TRI_COUNT[cases].astype(np.int64).sum())
        verts = np.empty((len(tvals), 3), _f32)
        tri_idx = np.empty((total, 3), np.int32)
        origin32 = np.ascontiguousarray(origin, _f32)
        got = lib.gsdf_mc_decode(
            _ptr(ids, ctypes.c_uint32), _ptr(cases, ctypes.c_uint8), len(ids),
            _ptr(tvals, ctypes.c_float), len(tvals), nx, ny, nz,
            _ptr(origin32, ctypes.c_float), ctypes.c_float(res),
            _ptr(_TRI_TABLE, ctypes.c_int8), _ptr(_TRI_COUNT, ctypes.c_uint8),
            _ptr(_EDGE_AXIS, ctypes.c_uint8), _ptr(_EDGE_LOW, ctypes.c_int8),
            _ptr(verts, ctypes.c_float), _ptr(tri_idx, ctypes.c_int32),
        )
    if got != total:
        raise ValueError(
            f"mc_decode failed (got {got}, expected {total}): "
            "unresolved owner cube (non-Lipschitz field?)"
        )
    return verts, tri_idx


def stl_encode_indexed(verts: np.ndarray, tri_idx: np.ndarray) -> bytes:
    """Indexed mesh -> STL record bytes (T*50): gather, normal and pack in
    one native pass."""
    verts = np.ascontiguousarray(verts, _f32)
    tri_idx = np.ascontiguousarray(tri_idx, np.int32)
    if tri_idx.ndim != 2 or tri_idx.shape[1] != 3:
        raise ValueError("tri_idx must be (T,3)")
    if len(tri_idx) and (tri_idx.min() < 0 or tri_idx.max() >= len(verts)):
        raise ValueError("triangle index outside the vertex array")
    n = tri_idx.shape[0]
    out = np.empty(n * 50, np.uint8)
    get_lib().gsdf_stl_encode_indexed(
        _ptr(verts, ctypes.c_float), _ptr(tri_idx, ctypes.c_int32), n,
        _ptr(out, ctypes.c_ubyte),
    )
    return out.tobytes()


def _soup(tris) -> np.ndarray:
    tris = np.ascontiguousarray(tris, _f32)
    if tris.ndim != 3 or tris.shape[1:] != (3, 3):
        raise ValueError("triangles must be (T,3,3)")
    return tris


def stl_encode(tris: np.ndarray) -> bytes:
    """(T,3,3) float32 triangles -> STL record bytes (T*50): normal from
    the winding, the three vertices, a zero attribute."""
    tris = _soup(tris)
    out = np.empty(len(tris) * 50, np.uint8)
    get_lib().gsdf_stl_encode(_ptr(tris, ctypes.c_float), len(tris), _ptr(out, ctypes.c_ubyte))
    return out.tobytes()


def stl_encode_plain(tris: np.ndarray) -> bytes:
    """stl_encode in numpy, with the C++'s float32 arithmetic: n =
    cross(v2-v1, v3-v1), divided by its length where that is > 0."""
    t = _soup(tris)
    e1, e2 = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    n = np.stack(
        [
            e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
            e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
            e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
        ],
        axis=-1,
    )
    ln = np.sqrt((n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        n = np.where(ln[:, None] > 0, n / ln[:, None], n).astype(_f32)
    rec = np.zeros(len(t), dtype=STL_DTYPE)
    rec["normal"] = n
    rec["v1"], rec["v2"], rec["v3"] = t[:, 0], t[:, 1], t[:, 2]
    return rec.tobytes()


def stl_decode(records: bytes, count: int) -> np.ndarray:
    """STL record bytes -> (count,3,3) float32 triangles."""
    buf = np.frombuffer(records, np.uint8, count=count * 50)
    tris = np.empty((count, 3, 3), _f32)
    get_lib().gsdf_stl_decode(_ptr(buf, ctypes.c_ubyte), count, _ptr(tris, ctypes.c_float))
    return tris


def stl_decode_plain(records: bytes, count: int) -> np.ndarray:
    rec = np.frombuffer(records, dtype=STL_DTYPE, count=count)
    return np.stack([rec["v1"], rec["v2"], rec["v3"]], axis=1).astype(_f32)


def weld(tris: np.ndarray, tol: float = 0.0):
    """Triangle soup -> indexed mesh (verts (V,3) f32, indices (T,3) i32),
    vertices in order of first appearance. Vertices whose coordinates
    round to the same multiple of `tol` merge; tol=0 merges coordinates
    within 1e-12 (exact duplicates at CAD scales)."""
    tris = _soup(tris)
    n = len(tris)
    if n == 0:
        return np.empty((0, 3), _f32), np.empty((0, 3), np.int32)
    verts = np.empty((n * 3, 3), _f32)
    idx = np.empty(n * 3, np.int32)
    nv = get_lib().gsdf_weld(
        _ptr(tris, ctypes.c_float), n, ctypes.c_float(tol),
        _ptr(verts, ctypes.c_float), _ptr(idx, ctypes.c_int32),
    )
    return verts[:nv].copy(), idx.reshape(-1, 3)


def dc_finish(verts, eax, lin, flips, nx, ny, nz, n_vox, offs, force_sort=False):
    """Dual-contour quad emission (gsdf_dc_finish): the triangles of every
    active edge whose four quad-corner voxels lie in the (nx, ny, nz)
    voxel space, gathered from `verts`, the vertices of the ascending
    unique voxel ids that the edges touch. `eax`/`lin` are each edge's axis
    and origin-voxel id, `offs` the (3,4,3) quad-corner offsets
    (render/dual_contour.py::_OFFS). Returns (tris (T,3,3) f32, block
    sizes). force_sort=True takes the sorted-table rank backend that voxel
    spaces past 2^28 take (the tests' lever for it). Raises RuntimeError
    when the voxels the edges touch are not n_vox, or an edge lies outside
    the grid."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, _f32)
    eax = np.ascontiguousarray(eax, np.int64)
    lin = np.ascontiguousarray(lin, np.int64)
    flips = np.ascontiguousarray(flips, np.uint8)
    offs = np.ascontiguousarray(offs, np.int32)
    n = len(eax)
    tris = np.empty((2 * n, 3, 3), _f32)
    blocks6 = np.zeros(6, np.int64)
    got = lib.gsdf_dc_finish(
        _ptr(verts, ctypes.c_float), _ptr(eax, ctypes.c_int64), _ptr(lin, ctypes.c_int64),
        _ptr(flips, ctypes.c_uint8), n, nx, ny, nz, n_vox, _ptr(offs, ctypes.c_int32),
        _ptr(tris, ctypes.c_float), _ptr(blocks6, ctypes.c_int64), 1 if force_sort else 0,
    )
    if got == -(2**63):  # INT64_MIN: an edge's axis or voxel outside the grid
        raise RuntimeError("corrupt DC payload: edge id out of range")
    if got < 0:
        raise RuntimeError(
            f"DC payload voxel-count mismatch: derived {-int(got) - 1} != kernel {n_vox}"
        )
    blocks = [int(b) for a in range(3) if blocks6[2 * a] for b in blocks6[2 * a : 2 * a + 2]]
    return tris[:got].copy(), blocks


def _llround(x: np.ndarray) -> np.ndarray:
    """C's llround on float64: nearest, ties away from zero."""
    r = np.rint(x)
    frac = x - np.trunc(x)
    return np.where(np.abs(frac) == 0.5, np.trunc(x) + np.sign(x), r).astype(np.int64)


def weld_plain(tris: np.ndarray, tol: float = 0.0):
    """weld in numpy: the same quantization (llround of the float64
    coordinate times the float32 1/tol, or 1e12 for tol <= 0) and the same
    first-appearance vertex order."""
    tris = _soup(tris)
    if len(tris) == 0:
        return np.empty((0, 3), _f32), np.empty((0, 3), np.int32)
    flat = tris.reshape(-1, 3)
    inv = float(_f32(1.0) / _f32(tol)) if tol > 0 else float(_f32(1e12))
    q = _llround(flat.astype(np.float64) * inv)
    _, first, inverse = np.unique(q, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # unique keys by first appearance
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return flat[first[order]].copy(), rank[inverse.reshape(-1)].astype(np.int32).reshape(-1, 3)
