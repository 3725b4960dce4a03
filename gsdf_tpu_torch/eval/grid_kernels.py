"""Dense grid evaluation on the card: the port of the JAX package's two
Pallas TPU kernels (gsdf_tpu/eval/pallas_grid.py).

- K2 `evaluate_grid`: distances at every corner of an (nk, nj, ni) grid,
  positions synthesised in-kernel (pallas_grid_eval_fn, :108-170).
- K1 `classified_grid`: the same evaluation and the marching-cubes
  classification, the first stage of every FlatRenderer path
  (pallas_classified_grid_fn, :187-346); one wrapper call launches its
  eval pass and its classify pass.

Both are hand-written CUDA C++ templates (gsdf_tpu_torch/csrc/) around
the per-tree distance function that codegen/cuda.py generates; nvcc
builds them for sm_90a at first use, cached by source hash under
build/gsdf_tpu_torch/. `build` also serves the two per-tree kernels of
eval/point_kernels.py (KP, K2-2D) and the raymarcher K8
(eval/ray_kernels.py), each a library of its own. On a CPU tensor device each wrapper runs its plain
torch version; on a CUDA device it launches the kernel or raises.

K1 and KP also have a parametric form (`parametric=True`): the same
templates around the tree's parametric source (codegen/cuda.py), one
library per tree STRUCTURE, cached by `structural_hash`. The tree's
continuous parameters (eval/parametric.py::kernel_params) go with every
launch: by value, as a kernel parameter that the card reads from its
constant bank (no upload, no synchronising call), up to
codegen.cuda.PARAMS_BY_VALUE_MAX floats; a longer vector is uploaded and
read through a pointer. Which of the two a library takes is fixed by the
vector's length when it is built. A parametric call never builds or
launches a baked library.

The pruned renderer's two per-tree kernels (render/pruned.py) live here
too, baked and parametric, in one library per tree (PRUNE_TEMPLATES):
- K6c `coarse_keep`: the keep mask of the coarse tile grid, the tree's
  distance at each tile centre against S*res*sqrt(3)/2
  (gsdf_tpu/render/pruned.py::_coarse_fn, :41-98);
- K6a `tile_grid`: the corners of T kept tiles as one atlas grid and its
  case grid (pruned.py::_tile_grid, :101-142, with the classification of
  ops/compact_field.py::tile_compact_emit, :288-303).

Grid layout is [k, j, i], x contiguous; the corner at integer index
(i, j, k) sits at origin + index * res in float32, from the global index.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build, spans
from ..codegen.cuda import tree_source
from .parametric import kernel_params, structural_hash
from ..kernels import (
    CSRC,
    LAUNCHES,
    NVCC_FLAGS,
    check_out,
    cuda_device,
    float_args,
    launch,
    nvcc,
)
from ..ops import dc_tables, mc_emit

_f32 = np.float32

TEMPLATES = ("grid_eval.cu", "classified_grid.cu")
#: the parametric K1 is a library of its own (K2 has no parametric form:
#: no caller of it takes `parametric` in the JAX package)
PARAM_TEMPLATES = ("classified_grid.cu",)
#: the pruned renderer's coarse pass (K6c) and tile atlas (K6a), baked or
#: parametric (K6cp, K6ap): one library of both per tree or structure
PRUNE_TEMPLATES = ("tile_prune.cu", "tile_atlas.cu")
#: included by the templates that have a parametric form
PARAMS_HEADER = "gsdf_params.cuh"
#: further headers a template includes: from csrc/, and generated beside
#: gsdf_tree.cuh (name -> the function that writes its text)
INCLUDES = {"dc_mesh.cu": ("gsdf_scan.cuh", "gsdf_qef.cuh", "gsdf_dc_words.cuh"),
            "classified_grid.cu": ("gsdf_case.cuh",), "tile_atlas.cu": ("gsdf_case.cuh",),
            "raymarch.cu": ("gsdf_raymarch.cuh",),
            "raymarch_sites.cu": ("raymarch.cu", "gsdf_raymarch.cuh")}
GENERATED = {"dc_mesh.cu": {"gsdf_dc_tables.cuh": dc_tables.header}}

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each per-tree template's C entry points (the last argument is the stream)
_SIGNATURES = {
    "grid_eval.cu": {"gsdf_grid_eval": (_I, [_V] + [_F] * 4 + [_I] * 4 + [_V])},
    "classified_grid.cu": {"gsdf_classified_grid": (_I, [_V] * 2 + [_F] * 5 + [_I] * 4 + [_V])},
    "point_eval.cu": {"gsdf_point_eval": (_I, [_V, ctypes.c_int64, _V, _V])},
    "grid_eval_2d.cu": {"gsdf_grid_eval_2d": (_I, [_V] + [_F] * 4 + [_I] * 2 + [_V])},
    "tile_prune.cu": {"gsdf_tile_prune": (_I, [_V] * 2 + [_F] * 6 + [_I] * 3 + [_V])},
    "tile_atlas.cu": {"gsdf_tile_atlas": (_I, [_V] * 3 + [_I] * 5 + [_F] * 5 + [_V])},
    "raymarch.cu": {"gsdf_raymarch": (_I, [_V] * 5 + [_I] * 3 + [_F, _I] + [_V])},
    "raymarch_sites.cu": {"gsdf_raymarch_sites": (_I, [_V] * 5 + [_I] * 3 + [_F, _I] + [_V, _V])},
    "dc_mesh.cu": {
        "gsdf_dc_work": (ctypes.c_int64, [_I] * 4),
        "gsdf_dc_count": (_I, [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4 + [_V]),
        "gsdf_dc_emit": (_I, [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4 + [_I] * 2 + [_F] * 3
                         + [_V] * 6 + [_V]),
    },
}
#: the parametric forms' entry points: the parameter vector (a host
#: pointer where the library takes it by value, else a device pointer)
#: goes before the stream; gsdf_params_by_value says which
_PARAM_SIGNATURES = {
    "classified_grid.cu": {
        "gsdf_classified_grid_param": (_I, [_V] * 2 + [_F] * 5 + [_I] * 4 + [_V, _I, _V])
    },
    "point_eval.cu": {"gsdf_point_eval_param": (_I, [_V, ctypes.c_int64, _V, _V, _I, _V])},
    "tile_prune.cu": {
        "gsdf_tile_prune_param": (_I, [_V] * 2 + [_F] * 6 + [_I] * 3 + [_V, _I, _V])
    },
    "tile_atlas.cu": {
        "gsdf_tile_atlas_param": (_I, [_V] * 3 + [_I] * 5 + [_F] * 5 + [_V, _I, _V])
    },
    "raymarch.cu": {"gsdf_raymarch_param": (_I, [_V] * 5 + [_I] * 3 + [_F, _I] + [_V, _I, _V])},
    "dc_mesh.cu": {
        "gsdf_dc_work": (ctypes.c_int64, [_I] * 4),
        "gsdf_dc_count_param": (_I, [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4 + [_V, _I, _V]),
        "gsdf_dc_emit_param": (_I, [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4 + [_I] * 2 + [_F] * 3
                               + [_V] * 6 + [_V, _I, _V]),
    },
}
_PARAM_INFO = {"gsdf_params_by_value": (_I, [])}

#: how a parametric library built from now on takes its vector: None by
#: the vector's length (codegen.cuda.PARAMS_BY_VALUE_MAX), True by value,
#: False through a pointer. Only tests and measurements set it.
PARAMS_BY_VALUE = None

#: (tree hash, templates) -> baked kernel library;
#: (structural hash, templates, "param", PARAMS_BY_VALUE) -> parametric one
_libs: dict = {}


def _sources(tree, templates, parametric=False):
    """(generated headers {name: text}, template paths, cache key) of one
    build: the tree's source (which states its NDIM), the headers the
    templates generate, and the named templates with what they include."""
    gen = {"gsdf_tree.cuh": tree_source(tree, parametric, PARAMS_BY_VALUE)}
    for t in templates:
        gen.update({name: text() for name, text in GENERATED.get(t, {}).items()})
    paths = [os.path.join(CSRC, t) for t in templates]
    headers = {PARAMS_HEADER, *(h for t in templates for h in INCLUDES.get(t, ()))}
    texts = []
    for p in paths + [os.path.join(CSRC, h) for h in sorted(headers)]:
        with open(p) as f:
            texts.append(f.read())
    key = _build.source_key(*(v for k in sorted(gen) for v in (k, gen[k])), *templates,
                            *texts, *NVCC_FLAGS)
    return gen, paths, key


def build(tree, templates=TEMPLATES, parametric=False) -> ctypes.CDLL:
    """The library of `templates` around the tree's generated source (K1 +
    K2 unless named otherwise), built by nvcc at first use. Each set of
    templates is a library of its own, so a render never pays for the
    point kernel's compile, nor a 2D tree for a 3D template. With
    parametric=True the source is the parametric one and the library
    serves every tree of this structure."""
    if parametric:
        key = (structural_hash(tree), templates, "param", PARAMS_BY_VALUE)
    else:
        key = (tree.tree_hash(), templates)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    gen, paths, source_key = _sources(tree, templates, parametric)

    def command(out, d):
        for name, text in gen.items():
            _build.write_atomic(os.path.join(d, name), text)
        return [nvcc(), *NVCC_FLAGS, "-I", d, "-I", CSRC, "-o", out, *paths]

    so = _build.build_shared("gsdf_tree", source_key, command)
    table = _PARAM_SIGNATURES if parametric else _SIGNATURES
    signatures = {fn: sig for t in templates for fn, sig in table[t].items()}
    lib = _build.load(so, {**signatures, **(_PARAM_INFO if parametric else {})})
    _libs[key] = lib
    return lib


def build_log(tree, templates=TEMPLATES, parametric=False) -> str:
    """nvcc's output (the ptxas register/spill report) for the tree."""
    build(tree, templates, parametric)
    key = _sources(tree, templates, parametric)[2]
    with open(os.path.join(_build.BUILD_DIR, f"gsdf_tree-{key}", "build.log")) as f:
        return f.read()


def _shape(shape):
    nk, nj, ni = (int(x) for x in shape)
    if min(nk, nj, ni) < 1:
        raise ValueError(f"empty grid shape {shape}")
    return nk, nj, ni


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


def classified_grid_plain(tree, origin, res, shape, device, k0: int = 0):
    """K1's plain version: (dist (nk,nj,ni) f32, cases (nk-1,nj-1,ni-1) u8)."""
    dist = evaluate_grid_plain(tree, origin, res, shape, device, k0)
    return dist, mc_emit.effective_cases(dist, res)


# --- kernel wrappers -------------------------------------------------------
def param_args(tree, lib, device):
    """A parametric launch's parameter arguments, (pointer, length,
    keep-alive): the tree's current vector in the kernels' layout, as the
    host array itself where the library takes it by value (the launch
    copies it into the kernel's parameter space), else uploaded from
    pinned memory with a copy that does not synchronise. The kernel checks
    the length against the structure's."""
    with spans.span("params.pack"):
        p = kernel_params(tree)
        if lib.gsdf_params_by_value():
            return p.ctypes.data, len(p), p
        t = torch.from_numpy(p).pin_memory().to(device, non_blocking=True)
        return t.data_ptr(), len(p), t


def evaluate_grid(tree, origin, res, shape, device, k0: int = 0):
    """Distances (nk, nj, ni) f32 at every grid corner (K2)."""
    nk, nj, ni = _shape(shape)
    if torch.device(device).type == "cpu":
        return evaluate_grid_plain(tree, origin, res, shape, device, k0)
    device = cuda_device(device)
    lib = build(tree)
    out = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    check_out(out, (nk, nj, ni), torch.float32, device)
    launch("grid_eval", device, lib.gsdf_grid_eval, out.data_ptr(),
           *float_args(origin, res), int(k0), nk, nj, ni)
    return out


def classified_grid(tree, origin, res, shape, device, k0: int = 0, parametric: bool = False):
    """Eval + classify (K1): (dist (nk,nj,ni) f32, cases
    (nk-1,nj-1,ni-1) u8), the case 0 where the cube is inactive. k0 is the
    slab's first plane in the whole grid. parametric=True runs the
    parametric form (K1p): the library of the tree's structure, with the
    tree's current continuous parameters as a launch argument."""
    nk, nj, ni = _shape(shape)
    if min(nk, nj, ni) < 2:
        raise ValueError(f"a classified grid needs >= 2 corners per axis, got {shape}")
    if torch.device(device).type == "cpu":
        return classified_grid_plain(tree, origin, res, shape, device, k0)
    device = cuda_device(device)
    lib = build(tree, PARAM_TEMPLATES, True) if parametric else build(tree)
    dist = torch.empty((nk, nj, ni), dtype=torch.float32, device=device)
    cases = torch.empty((nk - 1, nj - 1, ni - 1), dtype=torch.uint8, device=device)
    check_out(dist, (nk, nj, ni), torch.float32, device)
    check_out(cases, (nk - 1, nj - 1, ni - 1), torch.uint8, device)
    args = (dist.data_ptr(), cases.data_ptr(),
            *float_args(origin, res, mc_emit.quick_reject_threshold(res)), int(k0), nk, nj, ni)
    if parametric:
        ptr, n, _keep = param_args(tree, lib, device)
        launch("classified_grid_param", device, lib.gsdf_classified_grid_param, *args, ptr, n)
    else:
        launch("classified_grid", device, lib.gsdf_classified_grid, *args)
    return dist, cases


# --- the pruned renderer's coarse pass (K6c) and tile atlas (K6a) -------
def prune_constants(res, S: int):
    """(tres, half, thr) of the coarse pass in float32, in the JAX
    package's arithmetic (pruned.py:58-69): a tile's side S * res, its
    half, and the keep threshold side * f32(sqrt(3) / 2)."""
    tres = _f32(S) * _f32(res)
    return tres, tres * _f32(0.5), tres * _f32(np.sqrt(3) / 2)


def coarse_keep_plain(tree, origin, res, S, shape, device):
    """K6c's plain version: (keep (tz,ty,tx) u8, count (1,) int32)."""
    tz, ty, tx = _shape(shape)
    o = np.asarray(origin, _f32).reshape(3)
    tres, half, thr = (float(v) for v in prune_constants(res, S))

    def axis(n, origin_c):  # origin + idx * (S * res) + half
        idx = torch.arange(n, dtype=torch.int32, device=device).to(torch.float32)
        return float(origin_c) + idx * tres + half

    z = axis(tz, o[2])[:, None, None].expand(tz, ty, tx)
    y = axis(ty, o[1])[None, :, None].expand(tz, ty, tx)
    x = axis(tx, o[0])[None, None, :].expand(tz, ty, tx)
    keep = (torch.abs(tree.distance(torch.stack([x, y, z], dim=-1))) < thr).to(torch.uint8)
    return keep, keep.sum(dtype=torch.int32).reshape(1)


def coarse_keep(tree, origin, res, S, shape, device, parametric: bool = False):
    """The coarse pass of the pruned renderer (K6c): for the (tz, ty, tx)
    tiles of S^3 cubes, (keep u8 1 where |d(centre)| < S*res*sqrt(3)/2,
    count (1,) int32 of kept tiles). parametric=True runs K6cp, the
    library of the tree's structure with its current parameters."""
    tz, ty, tx = _shape(shape)
    if torch.device(device).type == "cpu":
        return coarse_keep_plain(tree, origin, res, S, shape, device)
    device = cuda_device(device)
    lib = build(tree, PRUNE_TEMPLATES, parametric)
    n = tz * ty * tx
    buf = torch.empty(-(-n // 4) + 1, dtype=torch.int32, device=device)  # mask, then count
    keep, count = buf.view(torch.uint8)[:n].view(tz, ty, tx), buf[-1:]
    args = (keep.data_ptr(), count.data_ptr(),
            *float_args(origin, *prune_constants(res, S)), tz, ty, tx)
    if parametric:
        ptr, n_params, _keep = param_args(tree, lib, device)
        launch("tile_prune_param", device, lib.gsdf_tile_prune_param, *args, ptr, n_params)
    else:
        launch("tile_prune", device, lib.gsdf_tile_prune, *args)
    return keep, count


def keep_to_host(keep, count):
    """(keep mask as a numpy u8 array, kept-tile count) on the host. K6c
    writes both into one int32 buffer (the mask's bytes, then the count),
    which comes over in ONE copy; the plain version's tensors are read as
    they are."""
    store = keep.untyped_storage()
    if count.untyped_storage().data_ptr() != store.data_ptr():
        return keep.cpu().numpy(), int(count.cpu()[0])
    host = torch.empty(0, dtype=torch.uint8, device=keep.device).set_(store).cpu()
    n, at = keep.numel(), keep.storage_offset()
    mask = host[at : at + n].numpy().reshape(keep.shape)
    c = count.storage_offset() * count.element_size()
    return mask, int(host[c : c + 4].view(torch.int32)[0])


def _tile_dims(tiles, S, dims):
    S = int(S)
    nx, ny, nz = (int(d) for d in dims)
    if S < 1 or min(nx, ny, nz) < 1 or tiles.ndim != 2 or tiles.shape[1] != 3 \
            or tiles.shape[0] < 1:
        raise ValueError(f"a tile atlas needs T >= 1 tiles (T, 3) and S >= 1, got "
                         f"{tuple(tiles.shape)}, S = {S}, dims {dims}")
    return tiles.shape[0], S, nx, ny, nz


def tile_positions(tiles, origin, res, S, device):
    """(T, P, P, P, 3) float32 corner positions of the T tiles (P = S + 1)
    from their global integer indices: origin + f32(tile * S + local) * res,
    K1's formula (grid_positions)."""
    T, P = tiles.shape[0], int(S) + 1
    tiles = tiles.to(device=device, dtype=torch.int64)
    local = torch.arange(P, dtype=torch.int64, device=device)
    o = np.asarray(origin, _f32).reshape(3)
    r = float(_f32(res))

    def axis(c):  # (T, P)
        return float(o[c]) + (tiles[:, c, None] * int(S) + local).to(torch.float32) * r

    x = axis(0)[:, None, None, :].expand(T, P, P, P)
    y = axis(1)[:, None, :, None].expand(T, P, P, P)
    z = axis(2)[:, :, None, None].expand(T, P, P, P)
    return torch.stack([x, y, z], dim=-1)


def tile_grid_plain(tree, tiles, origin, res, S, dims, device):
    """K6a's plain version: (dist (T*P, P, P) f32, cases (T*P-1, S, S)
    u8), the cases 0 on the seam layers and past the global grid."""
    T, S, nx, ny, nz = _tile_dims(tiles, S, dims)
    P = S + 1
    dist = tree.distance(tile_positions(tiles, origin, res, S, device)).reshape(T * P, P, P)
    cases = mc_emit.effective_cases(dist, res)
    tiles = tiles.to(device=device, dtype=torch.int64)
    ka = torch.arange(T * P - 1, device=device)
    t, lk = ka // P, ka % P
    local = torch.arange(S, device=device)
    in_k = (lk < S) & (tiles[t, 2] * S + lk < nz)  # lk == S: the seam between two tiles
    in_j = tiles[t, 1, None] * S + local < ny  # (T*P-1, S)
    in_i = tiles[t, 0, None] * S + local < nx
    inside = in_k[:, None, None] & in_j[:, :, None] & in_i[:, None, :]
    return dist, torch.where(inside, cases, 0).to(torch.uint8)


def tile_grid(tree, tiles, origin, res, S, dims, device, parametric: bool = False):
    """The tile atlas (K6a): tiles (T, 3) int32 [i, j, k] tile coordinates
    of S^3-cube tiles, dims (nx, ny, nz) the whole grid's cubes -> (dist
    (T*P, P, P) f32 corner distances, tile t's plane lk at atlas plane
    t*P + lk, P = S + 1; cases (T*P-1, S, S) u8 with K1's effective-case
    rule, 0 on the seam layer between two tiles and on cubes past the
    global grid). K3 and K4 read the pair as an ordinary grid.
    parametric=True runs K6ap."""
    T, S, nx, ny, nz = _tile_dims(tiles, S, dims)
    if torch.device(device).type == "cpu":
        return tile_grid_plain(tree, tiles, origin, res, S, dims, device)
    device = cuda_device(device)
    P = S + 1
    if T * P**3 >= 1 << 31:
        raise ValueError(f"a tile atlas of {T} tiles of {P}^3 corners exceeds int32 indices")
    check_out(tiles, (T, 3), torch.int32, device)
    lib = build(tree, PRUNE_TEMPLATES, parametric)
    dist = torch.empty((T * P, P, P), dtype=torch.float32, device=device)
    cases = torch.empty((T * P - 1, S, S), dtype=torch.uint8, device=device)
    args = (dist.data_ptr(), cases.data_ptr(), tiles.data_ptr(), T, S, nx, ny, nz,
            *float_args(origin, res, mc_emit.quick_reject_threshold(res)))
    if parametric:
        ptr, n_params, _keep = param_args(tree, lib, device)
        launch("tile_atlas_param", device, lib.gsdf_tile_atlas_param, *args, ptr, n_params)
    else:
        launch("tile_atlas", device, lib.gsdf_tile_atlas, *args)
    return dist, cases
