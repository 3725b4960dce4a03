"""Host-side native runtime of the port: the compact-payload decoder
(`gsdf_mc_decode`) and the indexed STL encoder, loaded with ctypes.

There is one C++ source of truth: the JAX package's
gsdf_tpu/native/native.cpp, compiled by path (reading a C++ file is no
Python import of gsdf_tpu) with the JAX package's flags
(gsdf_tpu/native/__init__.py:23-41) into the port's build directory. A
failed build raises; the port has no numpy fallback on its path.
`mc_decode_plain` is the numpy decoder kept as the plain version the
tests hold the C++ decoder against.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from ..ops import mc_emit
from ..ops.mc_tables import MC_TRI_COUNT, MC_TRI_TABLE

_f32 = np.float32

NATIVE_SRC = os.path.join(_build.REPO_ROOT, "gsdf_tpu", "native", "native.cpp")
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
}

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
