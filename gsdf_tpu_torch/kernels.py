"""What the port's CUDA kernel wrappers share: nvcc and its flags, the
launch counts, device and output checks, and the build of the
tree-independent marching-cubes kernels.

Kernels (all hand-written CUDA C++ in gsdf_tpu_torch/csrc/, nvcc sm_90a):

- K1 `classified_grid`, K2 `grid_eval`: per tree (eval/grid_kernels.py);
- K3 `compact_active`: order-preserving compaction of the active cubes,
  with the crossing-edge count and offsets K4 needs
  (ops/mc_emit.py::compact_active);
- K4 `compact_emit`: the compact payload's case bytes and owner-edge t
  (ops/compact_field.py::compact_emit);
- K7s `emit_soup`: triangle soup (ops/mc_emit.py::emit_triangles);
- K7w `emit_welded`: indexed mesh (ops/fused_welded.py::emit_welded).

K3, K4, K7s and K7w do not depend on the tree: each source builds once
into its own library, cached by a hash of its sources and flags under
build/gsdf_tpu_torch/. The MC tables reach them through a header
generated from ops/mc_tables.py (never retyped by hand). Nothing is
built when a module is imported, only at a wrapper's first CUDA call.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from . import _build
from .ops import mc_tables

#: launches per kernel; each wrapper adds one where it launches its kernel
LAUNCHES = {
    "classified_grid": 0,
    "grid_eval": 0,
    "compact_active": 0,
    "compact_emit": 0,
    "emit_soup": 0,
    "emit_welded": 0,
}

CSRC = os.path.join(_build.PKG_DIR, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    # no multiply-add contraction; IEEE division and sqrt (the defaults,
    # stated): golden counts hang on the sign of values near zero, and
    # t and vertices must equal the plain torch versions bit for bit
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
TABLES_HEADER = "gsdf_mc_tables.cuh"
SCAN_HEADER = os.path.join(CSRC, "gsdf_scan.cuh")

_V = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
#: the four tree-independent kernels' C entry points (source = name.cu)
STATIC_KERNELS = {
    "compact_active": {
        "gsdf_compact_work": (_I64, [_I64]),
        "gsdf_compact_active": (_I, [_V, _I64, _V, _V, _V]),
    },
    "compact_emit": {
        "gsdf_compact_emit": (_I, [_V, _V, _V, _I64, _I, _I, _V, _V, _V, _V]),
    },
    "emit_soup": {
        "gsdf_emit_soup_blocks": (_I64, [_I64]),
        "gsdf_emit_soup_count": (_I, [_V, _V, _I64, _V, _V, _V]),
        "gsdf_emit_soup": (
            _I, [_V, _V, _V, _I64, _I, _I] + [_F] * 5 + [_V, _V, _V],
        ),
    },
    "emit_welded": {
        "gsdf_emit_welded_blocks": (_I64, [_I64]),
        "gsdf_emit_welded_count": (_I, [_V, _V, _I64, _I64, _V, _V, _V, _V]),
        "gsdf_emit_welded": (
            _I,
            [_V, _V, _V, _I64, _I, _I, _I] + [_F] * 5 + [_V] * 7,
        ),
    },
}

_static_libs: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def cuda_device(device) -> torch.device:
    """`device` as an indexed CUDA device; raises for any other type."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels run on CUDA devices, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_out(t: torch.Tensor, shape, dtype, device) -> None:
    if (
        tuple(t.shape) != tuple(shape)
        or t.dtype != dtype
        or t.device != device
        or not t.is_contiguous()
    ):
        raise ValueError(
            f"kernel tensor {tuple(t.shape)} {t.dtype} {t.device} does not match "
            f"{tuple(shape)} {dtype} {device} contiguous"
        )


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def float_args(origin, res, *more) -> tuple:
    """origin (3,), res and any further scalars as the float32 values a
    kernel takes (ctypes passes each as a C float)."""
    o = np.asarray(origin, np.float32).reshape(3)
    return tuple(float(v) for v in (*o, np.float32(res), *map(np.float32, more)))


def _c_array(ctype: str, name: str, values) -> str:
    body = ", ".join(str(int(v)) for v in np.asarray(values).reshape(-1))
    return f"static __device__ const {ctype} {name}[{np.asarray(values).size}] = {{{body}}};\n"


def tables_header() -> str:
    """The MC tables as device arrays, generated from ops/mc_tables.py."""
    return (
        "// Generated by gsdf_tpu_torch/kernels.py from ops/mc_tables.py.\n"
        "#pragma once\n#include <cstdint>\n\n"
        + _c_array("uint8_t", "kTriCount", mc_tables.MC_TRI_COUNT)
        + _c_array("int8_t", "kTriTable", mc_tables.MC_TRI_TABLE)  # 256 x 15
        + _c_array("uint8_t", "kEdgePairs", mc_tables.MC_EDGE_PAIRS)  # 12 x 2
        + _c_array("uint8_t", "kCornerOffsets", mc_tables.CORNER_OFFSETS)  # 8 x 3
        + _c_array("uint8_t", "kEdgeAxis", mc_tables.EDGE_AXIS)  # 12
        + _c_array("uint8_t", "kEdgeLow", mc_tables.EDGE_LOW)  # 12 x 3
    )


def _static_source(name: str):
    """(source path, generated tables header, build cache key) of one
    tree-independent kernel."""
    src = os.path.join(CSRC, f"{name}.cu")
    header = tables_header()
    with open(src) as f, open(SCAN_HEADER) as g:
        key = _build.source_key(f.read(), g.read(), header, *NVCC_FLAGS)
    return src, header, key


def static_lib(name: str) -> ctypes.CDLL:
    """The library of one tree-independent kernel, built by nvcc at first
    use from csrc/<name>.cu."""
    lib = _static_libs.get(name)
    if lib is not None:
        return lib
    src, header, key = _static_source(name)

    def command(out, d):
        _build.write_atomic(os.path.join(d, TABLES_HEADER), header)
        return [nvcc(), *NVCC_FLAGS, "-I", d, "-I", CSRC, "-o", out, src]

    so = _build.build_shared(f"gsdf_{name}", key, command)
    lib = _build.load(so, STATIC_KERNELS[name])
    _static_libs[name] = lib
    return lib


def static_build_log(name: str) -> str:
    """nvcc's output (the ptxas register/spill report) for one kernel."""
    static_lib(name)
    key = _static_source(name)[2]
    with open(os.path.join(_build.BUILD_DIR, f"gsdf_{name}-{key}", "build.log")) as f:
        return f.read()
