"""Dense grid evaluation on the card: the port of the JAX package's two
Pallas TPU kernels (gsdf_tpu/eval/pallas_grid.py).

- K2 `evaluate_grid`: distances at every corner of an (nk, nj, ni) grid,
  positions synthesised in-kernel (pallas_grid_eval_fn, :108-170).
- K1 `classified_grid`: the same evaluation fused with marching-cubes
  classification, the first stage of FlatRenderer.render_compact
  (pallas_classified_grid_fn, :187-346).

Both are hand-written CUDA C++ templates (gsdf_tpu_torch/csrc/) around
the per-tree distance function that codegen/cuda.py generates; nvcc
builds them for sm_90a at first use, cached by source hash under
build/gsdf_tpu_torch/. On a CPU tensor device each wrapper runs its plain
torch version; on a CUDA device it launches the kernel or raises.

Grid layout is [k, j, i], x contiguous; the corner at integer index
(i, j, k) sits at origin + index * res in float32, from the global index.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from .. import _build
from ..codegen.cuda import tree_source
from ..ops import mc_emit

_f32 = np.float32

#: launches per kernel; each wrapper adds one where it launches its kernel
LAUNCHES = {"classified_grid": 0, "grid_eval": 0}

CSRC = os.path.join(_build.PKG_DIR, "csrc")
TEMPLATES = ("grid_eval.cu", "classified_grid.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    # no multiply-add contraction; IEEE division and sqrt (the defaults,
    # stated): golden counts hang on the sign of values near zero
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: cube layers a K1 block marches (the first plane is shared with the
#: block below, so evaluations grow by 1/KZ)
KZ = 16

_SIGNATURES = {
    "gsdf_grid_eval": (
        ctypes.c_int,
        [ctypes.c_void_p] + [ctypes.c_float] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
    "gsdf_classified_grid": (
        ctypes.c_int,
        [ctypes.c_void_p] * 2 + [ctypes.c_float] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
}

_libs: dict = {}  # tree hash -> loaded kernel library


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the grid kernels need the CUDA toolkit")
    return path


def _sources(tree):
    """(generated header, template paths, cache key) of the tree's build."""
    src = tree_source(tree)
    paths = [os.path.join(CSRC, t) for t in TEMPLATES]
    templates = []
    for p in paths:
        with open(p) as f:
            templates.append(f.read())
    return src, paths, _build.source_key(src, *templates, *NVCC_FLAGS)


def build(tree) -> ctypes.CDLL:
    """The tree's kernel library (K1 + K2), built by nvcc at first use."""
    lib = _libs.get(tree.tree_hash())
    if lib is not None:
        return lib
    src, paths, key = _sources(tree)

    def command(out, d):
        _build.write_atomic(os.path.join(d, "gsdf_tree.cuh"), src)
        return [_nvcc(), *NVCC_FLAGS, "-I", d, "-o", out, *paths]

    so = _build.build_shared("gsdf_tree", key, command)
    lib = _build.load(so, _SIGNATURES)
    _libs[tree.tree_hash()] = lib
    return lib


def build_log(tree) -> str:
    """nvcc's output (the ptxas register/spill report) for the tree."""
    build(tree)
    key = _sources(tree)[2]
    with open(os.path.join(_build.BUILD_DIR, f"gsdf_tree-{key}", "build.log")) as f:
        return f.read()


def _shape(shape):
    nk, nj, ni = (int(x) for x in shape)
    if min(nk, nj, ni) < 1:
        raise ValueError(f"empty grid shape {shape}")
    return nk, nj, ni


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the grid kernels run on CUDA devices, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_out(t: torch.Tensor, shape, dtype, device) -> None:
    if (
        tuple(t.shape) != tuple(shape)
        or t.dtype != dtype
        or t.device != device
        or not t.is_contiguous()
    ):
        raise ValueError(
            f"kernel output {tuple(t.shape)} {t.dtype} {t.device} does not match "
            f"{tuple(shape)} {dtype} {device} contiguous"
        )


def _launch_args(origin, res):
    o = np.asarray(origin, _f32).reshape(3)
    return float(o[0]), float(o[1]), float(o[2]), float(_f32(res))


# --- plain torch versions ------------------------------------------------
def grid_positions(origin, res, shape, device, k0: int = 0) -> torch.Tensor:
    """(nk, nj, ni, 3) float32 corner positions origin + index * res, from
    the global integer index (k offset by the slab's k0)."""
    nk, nj, ni = _shape(shape)
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))

    def axis(n, off, origin_c):
        idx = torch.arange(off, off + n, dtype=torch.int32, device=device)
        return float(origin_c) + idx.to(torch.float32) * r

    z = axis(nk, int(k0), o[2])[:, None, None].expand(nk, nj, ni)
    y = axis(nj, 0, o[1])[None, :, None].expand(nk, nj, ni)
    x = axis(ni, 0, o[0])[None, None, :].expand(nk, nj, ni)
    return torch.stack([x, y, z], dim=-1)


def evaluate_grid_plain(tree, origin, res, shape, device, k0: int = 0):
    """K2's plain version: the torch node tree on synthesised positions."""
    return tree.distance(grid_positions(origin, res, shape, device, k0))


def classified_grid_plain(tree, origin, res, shape, device):
    """K1's plain version: (dist (nk,nj,ni) f32, cases (nk-1,nj-1,ni-1) u8)."""
    dist = evaluate_grid_plain(tree, origin, res, shape, device)
    return dist, mc_emit.effective_cases(dist, res)


# --- kernel wrappers -------------------------------------------------------
def evaluate_grid(tree, origin, res, shape, device, k0: int = 0):
    """Distances (nk, nj, ni) f32 at every grid corner (K2)."""
    nk, nj, ni = _shape(shape)
    if torch.device(device).type == "cpu":
        return evaluate_grid_plain(tree, origin, res, shape, device, k0)
    device = _cuda(device)
    lib = build(tree)
    out = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    _check_out(out, (nk, nj, ni), torch.float32, device)
    ox, oy, oz, r = _launch_args(origin, res)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gsdf_grid_eval(out.data_ptr(), ox, oy, oz, r, int(k0), nk, nj, ni, stream)
    if rc != 0:
        raise RuntimeError(f"grid_eval kernel launch failed: CUDA error {rc}")
    LAUNCHES["grid_eval"] += 1
    return out


def classified_grid(tree, origin, res, shape, device):
    """Fused eval + classify (K1): (dist (nk,nj,ni) f32, cases
    (nk-1,nj-1,ni-1) u8), the case 0 where the cube is inactive."""
    nk, nj, ni = _shape(shape)
    if min(nk, nj, ni) < 2:
        raise ValueError(f"a classified grid needs >= 2 corners per axis, got {shape}")
    if torch.device(device).type == "cpu":
        return classified_grid_plain(tree, origin, res, shape, device)
    device = _cuda(device)
    lib = build(tree)
    dist = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    cases = torch.empty((nk - 1, nj - 1, ni - 1), dtype=torch.uint8, device=device)
    _check_out(dist, (nk, nj, ni), torch.float32, device)
    _check_out(cases, (nk - 1, nj - 1, ni - 1), torch.uint8, device)
    ox, oy, oz, r = _launch_args(origin, res)
    thr = float(mc_emit.quick_reject_threshold(res))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gsdf_classified_grid(
            dist.data_ptr(), cases.data_ptr(), ox, oy, oz, r, thr,
            nk, nj, ni, KZ, stream,
        )
    if rc != 0:
        raise RuntimeError(f"classified_grid kernel launch failed: CUDA error {rc}")
    LAUNCHES["classified_grid"] += 1
    return dist, cases
