"""How the port's CUDA kernels are built, loaded and launched: nvcc and
its flags, the registry of kernel sources (TEMPLATES, LIBRARIES), the
build of every kernel library and its cache, one launch call for both
forms of a library, the launch counts, and device and output checks.

Kernels (all hand-written CUDA C++ in gsdf_tpu_torch/csrc/, nvcc sm_90a):

- K1 `classified_grid`, K2 `grid_eval`: per tree (eval/grid_kernels.py);
- KP `point_eval`, K2-2D `grid_eval_2d`: per tree, distances at given
  points and on a 2D tree's pixel grid (eval/point_kernels.py);
- K1p `classified_grid_param`, KPp `point_eval_param`: the parametric
  forms of K1 and KP, per tree STRUCTURE: the tree's continuous
  parameters are a kernel argument, the templates are K1's and KP's;
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

Two kinds of library, each with a cache of its own:

- per tree (`build`): one of LIBRARIES, a set of templates around the
  tree's generated source (codegen/cuda.py), per tree hash. Each set is a
  library of its own, so a render never pays for the point kernel's
  compile, nor a 2D tree for a 3D template. With parametric=True the
  source is the parametric one and the library, one per tree STRUCTURE
  (`structural_hash`), serves every tree of it: the tree's continuous
  parameters (codegen/params.py::kernel_params) go with every launch, by
  value, as a kernel parameter that the card reads from its constant bank
  (no upload, no synchronising call), up to
  codegen.cuda.PARAMS_BY_VALUE_MAX floats; a longer vector is uploaded and
  read through a pointer. Which of the two a library takes is fixed by the
  vector's length when it is built. A parametric call never builds or
  launches a baked library.
- tree-independent (`static_lib`): K3, K4, K7s, K7w and the id map, each
  source a library of its own. The MC tables reach them through a header
  generated from ops/mc_tables.py (never retyped by hand).

Every library is built by nvcc at first use, cached by a hash of its
sources and flags under build/gsdf_tpu_torch/, and loaded as a `Library`,
whose `launch` runs any of its kernels in the library's form. Nothing is
built when a module is imported, only at a wrapper's first CUDA call.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from . import _build, spans
from .codegen.cuda import tree_source
from .codegen.params import kernel_params, structural_hash
from .ops import dc_tables, mc_tables

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
#: what every library of a kind is built with, whether or not its
#: templates include it: a per-tree library with the tree's generated
#: source and csrc/gsdf_params.cuh, a tree-independent one with the
#: generated MC tables header and csrc/gsdf_scan.cuh
TREE_HEADER = "gsdf_tree.cuh"
PARAMS_HEADER = "gsdf_params.cuh"
TABLES_HEADER = "gsdf_mc_tables.cuh"
SCAN_HEADER = os.path.join(CSRC, "gsdf_scan.cuh")

_V, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


class Template(NamedTuple):
    """What one kernel source, csrc/<name>.cu, is built and launched with."""

    #: its C launch entry points -> their argument types; each returns a
    #: CUDA error code and takes the stream after these
    entries: dict
    #: built around a tree's generated source; else tree-independent
    per_tree: bool = True
    #: has a parametric form: each entry point <fn>_param takes the
    #: parameter vector (a host pointer where the library takes it by
    #: value, else a device pointer) and its length before the stream
    parametric: bool = False
    #: the csrc/ files it includes besides its kind's (above)
    includes: tuple = ()
    #: headers generated beside it: (name, the function that writes its text)
    generated: tuple = ()
    #: its other C functions -> (return type, argument types)
    queries: dict = {}
    #: the LAUNCHES key its launches count under where it is not its own
    counts_as: str = ""


#: every kernel source of csrc/, by file name
TEMPLATES = {
    "grid_eval.cu": Template({"gsdf_grid_eval": [_V] + [_F] * 4 + [_I] * 4}),
    "classified_grid.cu": Template({"gsdf_classified_grid": [_V] * 2 + [_F] * 5 + [_I] * 4},
                                   parametric=True, includes=("gsdf_case.cuh",)),
    "point_eval.cu": Template({"gsdf_point_eval": [_V, _I64, _V]}, parametric=True),
    "grid_eval_2d.cu": Template({"gsdf_grid_eval_2d": [_V] + [_F] * 4 + [_I] * 2}),
    "tile_prune.cu": Template({"gsdf_tile_prune": [_V] * 2 + [_F] * 6 + [_I] * 3},
                              parametric=True),
    "tile_atlas.cu": Template({"gsdf_tile_atlas": [_V] * 3 + [_I] * 5 + [_F] * 5},
                              parametric=True, includes=("gsdf_case.cuh",)),
    "dc_mesh.cu": Template(
        {"gsdf_dc_count": [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4,
         "gsdf_dc_emit": [_V] + [_F] * 4 + [_I] * 5 + [_V] * 4 + [_I] * 2 + [_F] * 3 + [_V] * 6},
        parametric=True, includes=("gsdf_scan.cuh", "gsdf_qef.cuh", "gsdf_dc_words.cuh"),
        generated=(("gsdf_dc_tables.cuh", dc_tables.header),),
        queries={"gsdf_dc_work": (_I64, [_I] * 4)}),
    "raymarch.cu": Template({"gsdf_raymarch": [_V] * 5 + [_I] * 3 + [_F, _I]},
                            parametric=True, includes=("gsdf_raymarch.cuh",)),
    "raymarch_sites.cu": Template({"gsdf_raymarch_sites": [_V] * 5 + [_I] * 3 + [_F, _I, _V]},
                                  includes=("raymarch.cu", "gsdf_raymarch.cuh"),
                                  counts_as="raymarch"),
    "compact_active.cu": Template({"gsdf_compact_active": [_V, _I64, _V, _V, _V]},
                                  per_tree=False, queries={"gsdf_compact_work": (_I64, [_I64])}),
    "compact_emit.cu": Template({"gsdf_compact_emit": [_V, _V, _V, _I64, _I, _I, _V, _V, _V]},
                                per_tree=False),
    "emit_soup.cu": Template({"gsdf_emit_soup": [_V, _V, _V, _I64, _I, _I] + [_F] * 5 + [_V] * 3},
                             per_tree=False),
    "emit_welded.cu": Template(
        {"gsdf_emit_welded": [_V, _V, _V, _I64, _I, _I, _I] + [_F] * 5 + [_V] * 6},
        per_tree=False),
    "tile_global_ids.cu": Template({"gsdf_tile_global_ids": [_V, _I64, _V, _I, _I, _I, _V]},
                                   per_tree=False),
}
#: the per-tree libraries: name -> the templates built into it
LIBRARIES = {
    "grid": ("grid_eval.cu", "classified_grid.cu"),  # K2 + K1
    # K1p alone: K2 has no parametric form (no caller of it takes
    # `parametric` in the JAX package)
    "classified": ("classified_grid.cu",),
    "point": ("point_eval.cu",),  # KP
    "field": ("grid_eval_2d.cu",),  # K2-2D
    "prune": ("tile_prune.cu", "tile_atlas.cu"),  # K6c + K6a
    "dc": ("dc_mesh.cu",),  # K5
    "raymarch": ("raymarch.cu",),  # K8
    # K8's counting form, built only for a tree with short-circuit sites or
    # polygons
    "raymarch_sites": ("raymarch_sites.cu",),
}
#: the tree-independent kernels, each a library of its own (csrc/<name>.cu)
STATIC_KERNELS = tuple(t[: -len(".cu")] for t, spec in TEMPLATES.items() if not spec.per_tree)


def _launch_name(template: str, parametric: bool) -> str:
    """The LAUNCHES key of a launch of `template`'s kernels in one form."""
    name = TEMPLATES[template].counts_as or template[: -len(".cu")]
    return name + "_param" if parametric else name


#: launches per kernel form; each wrapper adds one where it launches its
#: kernel (through `Library.launch`)
LAUNCHES = {_launch_name(t, parametric): 0 for t, spec in TEMPLATES.items() if not spec.counts_as
            for parametric in ((False, True) if spec.parametric else (False,))}

#: how a parametric library built from now on takes its vector: None by
#: the vector's length (codegen.cuda.PARAMS_BY_VALUE_MAX), True by value,
#: False through a pointer. Only tests and measurements set it.
PARAMS_BY_VALUE = None

#: (tree hash, library) -> baked per-tree library;
#: (structural hash, library, "param", PARAMS_BY_VALUE) -> parametric one
_libs: dict = {}
#: name -> tree-independent library
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


def param_args(tree, lib, device):
    """A parametric launch's parameter arguments, (pointer, length,
    keep-alive): the tree's current vector in the kernels' layout, as the
    host array itself where the library takes it by value (the launch
    copies it into the kernel's parameter space), else uploaded from
    pinned memory with a copy that does not synchronise. The kernel checks
    the length against the structure's."""
    with spans.span("params.pack"):
        p = kernel_params(tree)
        if lib.by_value:
            return p.ctypes.data, len(p), p
        t = torch.from_numpy(p).pin_memory().to(device, non_blocking=True)
        return t.data_ptr(), len(p), t


class Library:
    """A loaded kernel library, baked or parametric: its C functions
    (`lib.gsdf_<fn>`) and one `launch` call for each of its kernels,
    whichever form the library is."""

    def __init__(self, cdll, templates, parametric: bool = False):
        self.cdll = cdll
        self.parametric = parametric
        #: a parametric library takes its vector by value, else through a
        #: device pointer
        self.by_value = bool(cdll.gsdf_params_by_value()) if parametric else None
        suffix = "_param" if parametric else ""
        #: kernel (an entry point's name after gsdf_) -> (LAUNCHES key, the
        #: entry point of this library's form)
        self._entries = {
            fn[len("gsdf_"):]: (_launch_name(t, parametric), getattr(cdll, fn + suffix))
            for t in templates for fn in TEMPLATES[t].entries
        }

    def __getattr__(self, name):
        return getattr(self.__dict__["cdll"], name)

    def launch(self, kernel: str, device: torch.device, *args, tree=None, params=None,
               count: bool = True):
        """Launch entry point gsdf_<kernel> of this library with `args`
        (`launch`). A parametric library calls its _param form, appends the
        current vector of `tree` and its length (`param_args`, or `params`:
        what an earlier call of the same wrapper returned) and counts the
        launch under <name>_param. Returns the parameter arguments it
        passed, None for a baked library."""
        name, entry = self._entries[kernel]
        if self.parametric:
            if params is None:
                params = param_args(tree, self, device)
            args = (*args, params[0], params[1])
        launch(name, device, entry, *args, count=count)
        return params


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


def _signatures(templates, parametric: bool) -> dict:
    """C function -> (return type, argument types) of a library of
    `templates` in one form: a parametric entry point is its baked one
    with the vector's pointer and length before the stream."""
    extra = [_V, _I] if parametric else []
    out = {"gsdf_params_by_value": (_I, [])} if parametric else {}
    for t in templates:
        spec = TEMPLATES[t]
        out.update(spec.queries)
        for fn, args in spec.entries.items():
            out[fn + "_param" if parametric else fn] = (_I, [*args, *extra, _V])
    return out


def _load(name: str, key: str, generated: dict, paths, templates, parametric=False) -> Library:
    """The library `name` of `templates` for build cache key `key`: nvcc on
    the source `paths`, the `generated` headers written beside them, at
    first use."""

    def command(out, d):
        for header, text in generated.items():
            _build.write_atomic(os.path.join(d, header), text)
        return [nvcc(), *NVCC_FLAGS, "-I", d, "-I", CSRC, "-o", out, *paths]

    so = _build.build_shared(name, key, command)
    return Library(_build.load(so, _signatures(templates, parametric)), templates, parametric)


def _log(name: str, key: str) -> str:
    with open(os.path.join(_build.BUILD_DIR, f"{name}-{key}", "build.log")) as f:
        return f.read()


def _sources(tree, library, parametric=False):
    """(generated headers {name: text}, template paths, cache key) of one
    per-tree build: the tree's source (which states its NDIM), the headers
    the templates generate, and the named templates with what they
    include."""
    templates = LIBRARIES[library]
    gen = {TREE_HEADER: tree_source(tree, parametric, PARAMS_BY_VALUE)}
    for t in templates:
        gen.update({name: text() for name, text in TEMPLATES[t].generated})
    paths = [os.path.join(CSRC, t) for t in templates]
    headers = {PARAMS_HEADER, *(h for t in templates for h in TEMPLATES[t].includes)}
    texts = []
    for p in paths + [os.path.join(CSRC, h) for h in sorted(headers)]:
        with open(p) as f:
            texts.append(f.read())
    key = _build.source_key(*(v for k in sorted(gen) for v in (k, gen[k])), *templates,
                            *texts, *NVCC_FLAGS)
    return gen, paths, key


def build(tree, library: str = "grid", parametric: bool = False) -> Library:
    """The per-tree library `library` (one of LIBRARIES) around the tree's
    generated source, built by nvcc at first use. With parametric=True the
    source is the parametric one and the library serves every tree of this
    structure."""
    if parametric:
        key = (structural_hash(tree), library, "param", PARAMS_BY_VALUE)
    else:
        key = (tree.tree_hash(), library)
    lib = _libs.get(key)
    if lib is None:
        gen, paths, source_key = _sources(tree, library, parametric)
        lib = _libs[key] = _load("gsdf_tree", source_key, gen, paths, LIBRARIES[library],
                                 parametric)
    return lib


def build_log(tree, library: str = "grid", parametric: bool = False) -> str:
    """nvcc's output (the ptxas register/spill report) for the tree."""
    build(tree, library, parametric)
    return _log("gsdf_tree", _sources(tree, library, parametric)[2])


def _static_source(name: str):
    """(source path, generated tables header, build cache key) of one
    tree-independent kernel."""
    src = os.path.join(CSRC, f"{name}.cu")
    header = tables_header()
    with open(src) as f, open(SCAN_HEADER) as g:
        key = _build.source_key(f.read(), g.read(), header, *NVCC_FLAGS)
    return src, header, key


def static_lib(name: str) -> Library:
    """The library of one tree-independent kernel, built by nvcc at first
    use from csrc/<name>.cu."""
    lib = _static_libs.get(name)
    if lib is None:
        src, header, key = _static_source(name)
        lib = _static_libs[name] = _load(f"gsdf_{name}", key, {TABLES_HEADER: header}, [src],
                                         (f"{name}.cu",))
    return lib


def static_build_log(name: str) -> str:
    """nvcc's output (the ptxas register/spill report) for one kernel."""
    static_lib(name)
    return _log(f"gsdf_{name}", _static_source(name)[2])
