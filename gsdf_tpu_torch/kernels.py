"""What the port's CUDA kernel wrappers share: nvcc and its flags, the
launch counts, device and output checks, and the build of the
tree-independent marching-cubes kernels.

Kernels (all hand-written CUDA C++ in gsdf_tpu_torch/csrc/, nvcc sm_90a):

- K1 `classified_grid`, K2 `grid_eval`: per tree (eval/grid_kernels.py);
- KP `point_eval`, K2-2D `grid_eval_2d`: per tree, distances at given
  points and on a 2D tree's pixel grid (eval/point_kernels.py);
- K1p `classified_grid_param`, KPp `point_eval_param`: the parametric
  forms of K1 and KP, per tree STRUCTURE: the tree's continuous
  parameters are a kernel argument (eval/parametric.py), the templates
  are K1's and KP's;
- K3 `compact_active`: order-preserving compaction of the active cubes,
  with the crossing-edge and triangle counts and block offsets that K4,
  K7s and K7w need (ops/mc_emit.py::compact_active);
- K4 `compact_emit`: the compact payload's case bytes and owner-edge t
  (ops/compact_field.py::compact_emit);
- K7s `emit_soup`: triangle soup (ops/mc_emit.py::emit_triangles);
- K7w `emit_welded`: indexed mesh (ops/fused_welded.py::emit_welded);
- K5 `dc_mesh`, K5p `dc_mesh_param`: dual contouring's device stage, per
  tree (K5p per tree STRUCTURE), from the tree to the live voxels'
  vertices (ops/dc_emit.py);
- K6c `tile_prune`, K6a `tile_atlas` and their parametric forms K6cp
  `tile_prune_param`, K6ap `tile_atlas_param`: the pruned renderer's
  coarse keep mask and the corner atlas + case grid of the kept tiles, per
  tree (eval/grid_kernels.py::coarse_keep, tile_grid; render/pruned.py);
- `tile_global_ids`: the atlas cube ids that K3 returns as the global cube
  ids of the whole grid (ops/compact_field.py::tile_global_ids). K7s has
  a tile mode that places the atlas's triangles by global index;
- K8 `raymarch`, K8p `raymarch_param`: the raymarcher, per tree (K8p per
  tree STRUCTURE), from a camera to a shaded u8 image: sphere tracing,
  normals, shading and the supersampling box filter (eval/ray_kernels.py).

K3, K4, K7s, K7w and the id map do not depend on the tree: each source
builds once into its own library, cached by a hash of its sources and
flags under build/gsdf_tpu_torch/. The MC tables reach them through a
header generated from ops/mc_tables.py (never retyped by hand). Nothing
is built when a module is imported, only at a wrapper's first CUDA call.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from . import _build, spans
from .ops import mc_tables

#: launches per kernel; each wrapper adds one where it launches its kernel
#: (through `launch`)
LAUNCHES = {
    "classified_grid": 0,
    "grid_eval": 0,
    "point_eval": 0,
    "grid_eval_2d": 0,
    "classified_grid_param": 0,
    "point_eval_param": 0,
    "compact_active": 0,
    "compact_emit": 0,
    "emit_soup": 0,
    "emit_welded": 0,
    "dc_mesh": 0,
    "dc_mesh_param": 0,
    "tile_prune": 0,
    "tile_atlas": 0,
    "tile_prune_param": 0,
    "tile_atlas_param": 0,
    "tile_global_ids": 0,
    "raymarch": 0,
    "raymarch_param": 0,
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
#: the tree-independent kernels' C entry points (source = name.cu)
STATIC_KERNELS = {
    "compact_active": {
        "gsdf_compact_work": (_I64, [_I64]),
        "gsdf_compact_active": (_I, [_V, _I64, _V, _V, _V, _V]),
    },
    "compact_emit": {
        "gsdf_compact_emit": (_I, [_V, _V, _V, _I64, _I, _I, _V, _V, _V, _V]),
    },
    "emit_soup": {
        "gsdf_emit_soup": (
            _I, [_V, _V, _V, _I64, _I, _I] + [_F] * 5 + [_V] * 4,
        ),
    },
    "emit_welded": {
        "gsdf_emit_welded": (
            _I,
            [_V, _V, _V, _I64, _I, _I, _I] + [_F] * 5 + [_V] * 7,
        ),
    },
    "tile_global_ids": {
        "gsdf_tile_global_ids": (_I, [_V, _I64, _V, _I, _I, _I, _V, _V]),
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
    """`device` as an indexed CUDA device; raises for any other type, and
    where there is no card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels run on CUDA devices, not {device}")
    if device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a CPU run")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_device() -> torch.device:
    """Where every entry point of the port runs when the caller names no
    device: the card. With no card such a call raises (`entry_device`); it
    does not carry on on the CPU."""
    return torch.device("cuda")


def entry_device(device=None) -> torch.device:
    """An entry point's `device` argument as the device it runs on: the
    default for None, a CUDA device with its index, or the CPU."""
    device = default_device() if device is None else torch.device(device)
    return device if device.type == "cpu" else cuda_device(device)


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


def launch(name: str, device: torch.device, entry, *args, count: bool = True) -> None:
    """Call the C entry point of kernel `name` with `args` and, last, the
    current stream of `device` (an indexed CUDA device, made current for
    the call); raise unless the kernel launched, and count the launch
    (count=False for the second call of a wrapper that launches its
    kernel's passes in two calls, around a read of its counts). A
    wrapper's own Python is most of what a small grid pays per call, so
    the stream comes from torch's raw getter and the device is switched
    only where it is not current already."""
    raw = torch._C._cuda_getCurrentRawStream(device.index)
    with spans.span("launch." + name):
        if device.index == torch.cuda.current_device():
            rc = entry(*args, raw)
        else:
            with torch.cuda.device(device):
                rc = entry(*args, raw)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if count:
        LAUNCHES[name] += 1


def float_args(origin, res, *more) -> list:
    """origin (3,), res and any further scalars as the float32 values a
    kernel takes (ctypes passes each as a C float)."""
    o = np.asarray(origin, np.float32).reshape(3)
    return np.array((o[0], o[1], o[2], res, *more), np.float32).tolist()


def _c_array(ctype: str, name: str, values) -> str:
    body = ", ".join(str(int(v)) for v in np.asarray(values).reshape(-1))
    return f"static __device__ constexpr {ctype} {name}[{np.asarray(values).size}] = {{{body}}};\n"


def owner_edges() -> np.ndarray:
    """(7,3) cube edge number by owner and axis, -1 where there is none.
    Owner o is the neighbour cube at offset (o & 1, o >> 1 & 1, o >> 2)
    whose corner 0 is the low end of the edge: the inverse of EDGE_LOW and
    EDGE_AXIS, so that a kernel can walk a cube's 12 edges owner by owner
    (owner 0 is the cube itself; the cube at (1, 1, 1) owns none)."""
    out = np.full((7, 3), -1, np.int32)
    for e, (low, ax) in enumerate(zip(mc_tables.EDGE_LOW, mc_tables.EDGE_AXIS)):
        out[int(low[0]) + 2 * int(low[1]) + 4 * int(low[2]), int(ax)] = e
    return out


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
        + _c_array("int8_t", "kOwnerEdge", owner_edges())  # 7 x 3
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
