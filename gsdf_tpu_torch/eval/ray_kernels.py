"""Raymarching on the card: K8, the per-tree kernel behind
visual/raymarch.py, and its plain torch version.

- K8 `raymarch`: a shaded (height, width, 3) u8 image of a 3D tree, each
  of its (aa*height) x (aa*width) supersamples sphere traced, shaded and
  box-filtered down on the card. Counterpart of the XLA-jitted
  `_raymarch_fn` of the JAX package (gsdf_tpu/visual/raymarch.py:26-181).

A hand-written CUDA C++ template (csrc/raymarch.cu, the per-ray arithmetic
in csrc/gsdf_raymarch.cuh) around the tree's generated `gsdf_tree`, built
into a library of its own ("raymarch" of kernels.LIBRARIES) at the
wrapper's first CUDA call. The frame's size, step count, relaxation, aa and
camera are launch arguments, so one library serves every frame of a tree.
The kernel is persistent: warps take rays from a queue and refill a lane
whose ray is done (csrc/raymarch.cu); the wrapper gives it the queue's
counter, one int32 that the C entry point zeroes. On the CPU the wrapper
runs its plain torch version; on a CUDA device it launches its kernel or
raises.

K8 has a parametric form, K8p (`raymarch(..., parametric=True)`): the same
template around the tree's parametric source, one library per tree
structure, the tree's continuous parameters a launch argument
(kernels.py). Counterpart of `_raymarch_fn(parametric=True)`
(raymarch.py:150-169).

Short circuits. A tree's baked source may return a Difference's minuend
before it evaluates a subtrahend that cannot change the result, and skip a
union's member whose point bound the members run before it undercut
(codegen/cuda.py), and walk only the members of a translate-group loop
that a bin table lists near the point; a polygon's edge divides only
where the clamp does not decide (core/primitives2.py::Polygon2D).
`count_short_circuits` runs K8's counting form on such a tree
(csrc/raymarch_sites.cu, "raymarch_sites", a library of its own around the
same generated code): the same image and evaluations, and per site how
often the skip engaged and per loop how many members it walked, added to
SHORT_CIRCUITS, and per polygon how many edges divided, added to
EDGE_DIVISIONS. `raymarch`, with or without evals, runs K8 itself, which
counts nothing.

The march. Every call that returns evaluations (`raymarch(...,
evals=True)`, on the card or its plain version on the CPU, and
`count_short_circuits`) adds its frame, rays and tree evaluations to
MARCH; a call without evals, the viewer's, counts nothing and
synchronises nothing.

The camera is 20 float32 numbers made once a frame on the host
(`pack_camera`, visual/raymarch.py::camera): the kernel and the plain
version take the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codegen.cuda import tree_loops, tree_polygons, tree_sites
from ..core import mathx as mx
from ..kernels import build, check_out, entry_device

_f32 = np.float32

#: what K8's counting launches (count_short_circuits) saw at each short-circuit site,
#: summed over calls since the last clear: the site's name (codegen.cuda's
#: Codegen.sites) -> {"subtrahend": a Difference's subtrahend's function and
#: "bound": its lower bound, or "member": a union member's function and
#: "bound": "point"; "lanes": lane evaluations that reached the site,
#: "lane_skips": of them those that skipped the function, "turns": warp
#: turns in which a lane reached it, "turn_skips": of them those in which
#: every such lane skipped}; and at each bin-table loop (codegen.cuda's
#: Codegen.loops) its name -> {"loop": the member's function, "members":
#: the loop's length; "entries": lane evaluations that entered it,
#: "walked": the members they walked, "turns": warp turns in which a lane
#: entered it, "turn_walked": the members the warp walked in them (each
#: turn's longest walk)}
SHORT_CIRCUITS: dict = {}
_SITE_COUNTS = ("lanes", "lane_skips", "turns", "turn_skips")
_LOOP_COUNTS = ("entries", "walked", "turns", "turn_walked")
#: what K8's counting launches saw at each polygon's edge loop, summed over
#: calls since the last clear, by the polygon's function (codegen.cuda's
#: Codegen.polygons): {"edges": the loop's length, "lanes": lane edge
#: evaluations, "lane_divisions": of them those that divided, "turns": warp
#: edge turns (one a group of lanes that ran the loop together, an edge),
#: "turn_divisions": of them those in which a lane divided}. Kept apart from
#: SHORT_CIRCUITS, whose every entry is a site or loop that skips work
EDGE_DIVISIONS: dict = {}
_EDGE_COUNTS = ("lanes", "lane_divisions", "turns", "turn_divisions")
# tree hash -> (tree_sites(tree), tree_loops(tree), tree_polygons(tree))
_sites: dict = {}
#: the frames, their rays (supersamples) and the rays' tree evaluations
#: (march steps and the 5 of shading) of every call that returned
#: evaluations, summed
MARCH: dict = {"frames": 0, "rays": 0, "evaluations": 0}
#: gsdf_rm::Camera's fields in order, and their lengths
CAMERA_FIELDS = (("ro", 3), ("uu", 3), ("vv", 3), ("ww", 3), ("center", 3), ("light", 3),
                 ("scale", 1), ("far_plane", 1))
CAMERA_FLOATS = 20
#: the tetrahedral normal's offsets k1..k4 (raymarch.py:112-115)
NORMAL_K = np.array([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], _f32)
#: hit tests: the march's |d| and the final |d| (raymarch.py:95, :110)
MARCH_EPS, HIT_EPS, NORMAL_H = _f32(1e-4), _f32(1e-3), _f32(1e-4)
BASE, SKY = np.array([0.85, 0.6, 0.3], _f32), np.array([0.65, 0.78, 0.9], _f32)
GAMMA = _f32(1 / 2.2)


def pack_camera(ro, uu, vv, ww, center, light, scale, far_plane) -> np.ndarray:
    """The 20 float32 numbers of one frame, in gsdf_rm::Camera's layout."""
    parts = (ro, uu, vv, ww, center, light, [scale], [far_plane])
    return np.concatenate([np.asarray(p, _f32).reshape(-1) for p in parts]).astype(_f32)


def unpack_camera(camera) -> dict:
    """name -> float32 numpy value of each field of a packed camera."""
    c = np.asarray(camera, _f32).reshape(CAMERA_FLOATS)
    out, at = {}, 0
    for name, n in CAMERA_FIELDS:
        out[name] = c[at] if n == 1 else c[at : at + n]
        at += n
    return out


def _frame(width, height, steps, aa):
    width, height, steps, aa = int(width), int(height), int(steps), int(aa)
    if width < 1 or height < 1 or steps < 0 or aa < 1:
        raise ValueError(f"a raymarched frame needs width, height, aa >= 1 and steps >= 0, "
                         f"got {width} x {height}, steps {steps}, aa {aa}")
    return width, height, steps, aa


# --- plain torch version -------------------------------------------------
def frame_consts(camera, relax, device) -> dict:
    """The camera's fields and the frame's other constants as float32
    tensors on `device` (0-dim where a scalar, so that no division or
    product takes a host scalar: mathx's note), as the pieces below take
    them."""
    c = unpack_camera(camera)
    like = torch.empty(0, device=device)
    out = {k: mx.const(v, like) for k, v in c.items()}
    out.update(ww18=mx.const(_f32(1.8) * c["ww"], like),  # 1.8 * ww, in float32
               relax=mx.const(_f32(relax), like), march_eps=mx.const(MARCH_EPS, like),
               hit_eps=mx.const(HIT_EPS, like), tiny=mx.const(_f32(1e-20), like),
               kh=mx.const(NORMAL_K * NORMAL_H, like), base=mx.const(BASE, like),
               sky=mx.const(SKY, like))
    return out


def rays(c: dict, rw: int, rh: int, device) -> torch.Tensor:
    """(rh * rw, 3) unit ray directions of the supersamples, row-major,
    in the JAX package's operations and order (raymarch.py:60-88)."""
    iy = torch.arange(rh, dtype=torch.float32, device=device)[:, None].expand(rh, rw)
    ix = torch.arange(rw, dtype=torch.float32, device=device)[None, :].expand(rh, rw)
    w, h = mx.const(_f32(rw), ix), mx.const(_f32(rh), ix)
    ux = mx.div(2.0 * ix - w, h).reshape(-1)
    uy = mx.div(-(2.0 * iy - h), h).reshape(-1)
    r = [(ux * c["uu"][k] + uy * c["vv"][k]) + c["ww18"][k] for k in range(3)]
    length = mx.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
    return torch.stack([mx.div(x, length) for x in r], -1)


def scene(tree, c: dict, p: torch.Tensor) -> torch.Tensor:
    """tree(p * scale + center) / scale (raymarch.py:65-66)."""
    return mx.div(tree.distance(p * c["scale"] + c["center"]), c["scale"])


def march_step(tree, c: dict, rd: torch.Tensor, t: torch.Tensor):
    """One sphere-tracing step of the rays that are not done: (t after it,
    done after it). A hit keeps its t; a miss moves by d * relax and is
    done past the far plane (raymarch.py:91-106)."""
    d = scene(tree, c, c["ro"] + rd * t[:, None])
    hit = torch.abs(d) < c["march_eps"]
    moved = t + d * c["relax"]
    return torch.where(hit, t, moved), hit | (moved > c["far_plane"])


def shade(tree, c: dict, rd: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, 3) u8 colours of rays that stopped at t: the final distance and
    the four tetrahedral offsets in one tree call, then the shading
    (raymarch.py:108-138)."""
    pos = c["ro"] + rd * t[:, None]
    offsets = [pos] + [pos + c["kh"][q] for q in range(4)]
    d = scene(tree, c, torch.cat(offsets)).reshape(5, -1)
    k = NORMAL_K.tolist()  # +-1.0 as Python floats
    n = [((k[0][a] * d[1] + k[1][a] * d[2]) + k[2][a] * d[3]) + k[3][a] * d[4] for a in range(3)]
    length = mx.sqrt(((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]) + c["tiny"])
    n = [mx.div(x, length) for x in n]
    light = c["light"]
    dif = torch.clamp((n[0] * light[0] + n[1] * light[1]) + n[2] * light[2], 0.0, 1.0)
    amb = 0.5 + 0.5 * n[2]
    lit = 0.25 * amb + 0.8 * dif
    rn2 = 2.0 * ((rd[:, 0] * n[0] + rd[:, 1] * n[1]) + rd[:, 2] * n[2])
    r = [rd[:, a] - rn2 * n[a] for a in range(3)]
    spec = torch.clamp((r[0] * light[0] + r[1] * light[1]) + r[2] * light[2], 0.0, 1.0)
    for _ in range(4):  # ** 16: XLA's integer_pow, four squarings
        spec = spec * spec
    hit = torch.abs(d[0]) < c["hit_eps"]
    col = torch.stack([torch.where(hit, c["base"][a] * lit + 0.15 * spec,
                                   c["sky"][a] - 0.4 * rd[:, 2]) for a in range(3)], -1)
    col = torch.clamp(col, 0.0, 1.0)
    if col.device.type == "cpu":  # mathx's note: torch's float32 CPU pow is not rounded once
        col = torch.pow(col.double(), float(GAMMA)).float()
    else:
        col = torch.pow(col, float(GAMMA))
    return (col * 255.0).to(torch.uint8)


def box_filter(img: torch.Tensor, width: int, height: int, aa: int) -> torch.Tensor:
    """(height, width, 3) u8 from the (aa*height, aa*width, 3) u8 samples:
    (2 s + n) // (2 n) (raymarch.py:140-148)."""
    if aa == 1:
        return img
    s = img.reshape(height, aa, width, aa, 3).to(torch.int32).sum(dim=(1, 3))
    n = aa * aa
    return torch.div(2 * s + n, 2 * n, rounding_mode="floor").to(torch.uint8)


def raymarch_plain(tree, camera, width, height, steps, relax, aa, device, evals=False):
    """K8's plain version: the torch node tree, each step on the rays that
    are not done (a done ray's t no longer changes, as in the JAX
    package's masked loop), so it does K8's work and no more. Returns the
    (height, width, 3) u8 image, and with evals=True also the (aa*height,
    aa*width) int32 tree evaluations of each supersample (its steps and
    5)."""
    width, height, steps, aa = _frame(width, height, steps, aa)
    rw, rh = width * aa, height * aa
    c = frame_consts(camera, relax, device)
    rd = rays(c, rw, rh, device)
    t = torch.zeros(rw * rh, dtype=torch.float32, device=device)
    n_evals = torch.full((rw * rh,), 5, dtype=torch.int32, device=device)
    live = torch.arange(rw * rh, device=device)
    for _ in range(steps):
        if not live.numel():
            break
        t_live, done = march_step(tree, c, rd[live], t[live])
        t[live] = t_live
        n_evals[live] += 1
        live = live[~done]
    img = box_filter(shade(tree, c, rd, t).reshape(rh, rw, 3), width, height, aa)
    return (img, n_evals.reshape(rh, rw)) if evals else img


# --- kernel wrapper ----------------------------------------------------------
def _tree_sites(tree) -> tuple:
    key = tree.tree_hash()
    if key not in _sites:
        _sites[key] = (tree_sites(tree), tree_loops(tree), tree_polygons(tree))
    return _sites[key]


def sites(tree) -> list:
    """The short-circuit sites of the 3D tree's baked source
    (codegen.cuda.tree_sites), kept per tree hash."""
    return _tree_sites(tree)[0]


def loops(tree) -> list:
    """The bin-table loops of the 3D tree's baked source
    (codegen.cuda.tree_loops), kept per tree hash."""
    return _tree_sites(tree)[1]


def polygons(tree) -> list:
    """The polygons' edge loops of the 3D tree's baked source
    (codegen.cuda.tree_polygons), kept per tree hash."""
    return _tree_sites(tree)[2]


def edge_division_shares() -> dict:
    """{polygon: {"edges", "lane_share", "warp_share"}} from
    EDGE_DIVISIONS: the share of lane edge evaluations that divided, and of
    warp edge turns in which a lane divided (None where none ran)."""
    return {fn: {"edges": c["edges"],
                 "lane_share": c["lane_divisions"] / c["lanes"] if c["lanes"] else None,
                 "warp_share": c["turn_divisions"] / c["turns"] if c["turns"] else None}
            for fn, c in EDGE_DIVISIONS.items()}


def short_circuit_shares() -> dict:
    """{site: {"subtrahend" or "member", "lane_share", "warp_share"}} from
    SHORT_CIRCUITS: the share of lane evaluations reaching the site that
    skipped its function, and of warp turns reaching it in which the
    whole warp skipped it (None where none reached it); and {loop: {"loop",
    "members", "lane_members", "warp_members"}}: the members walked a lane
    entry and a warp turn that entered it."""
    out = {}
    for site, c in SHORT_CIRCUITS.items():
        if "loop" in c:
            out[site] = {"loop": c["loop"], "members": c["members"],
                         "lane_members": c["walked"] / c["entries"] if c["entries"] else None,
                         "warp_members": c["turn_walked"] / c["turns"] if c["turns"] else None}
            continue
        out[site] = {**{k: c[k] for k in ("subtrahend", "member") if k in c},
                     "lane_share": c["lane_skips"] / c["lanes"] if c["lanes"] else None,
                     "warp_share": c["turn_skips"] / c["turns"] if c["turns"] else None}
    return out


def raymarch(tree, camera, width, height, steps, relax, aa, device, parametric=False,
             evals=False):
    """The shaded (height, width, 3) u8 image of the 3D `tree` under
    `camera` (pack_camera's 20 floats) on `device` (K8; K8p with
    parametric=True, through the library of the tree's structure), not
    synchronised: one wrapper call, a 4-byte memset of the ray queue's
    counter and one launch (and the box filter's where aa > 1). With
    evals=True also the (aa*height, aa*width) int32 tree evaluations of
    each supersample, added to MARCH (one synchronisation)."""
    return _raymarch(tree, camera, width, height, steps, relax, aa, device, parametric, evals,
                     count=False)


def count_short_circuits(tree, camera, width, height, steps, relax, aa, device):
    """K8's counting form on the 3D `tree`'s short-circuit sites and
    polygons: the image and evaluations of raymarch(..., evals=True), and
    per site the lane evaluations and warp turns that reached it and that
    skipped its function, and per bin-table loop the members walked, added
    to SHORT_CIRCUITS; per polygon's edge loop the lane edge evaluations
    and warp edge turns and those that divided, added to EDGE_DIVISIONS;
    and the evaluations to MARCH (one synchronisation). On a tree with
    neither, K8 itself and nothing counted but MARCH. A card's: the plain
    version has no warps."""
    if entry_device(device).type == "cpu":
        raise ValueError("the short-circuit counter is K8's: it needs a CUDA device")
    return _raymarch(tree, camera, width, height, steps, relax, aa, device, False, True,
                     count=True)


def _raymarch(tree, camera, width, height, steps, relax, aa, device, parametric, evals, count):
    width, height, steps, aa = _frame(width, height, steps, aa)
    if tree.NDIM != 3:
        raise TypeError(f"the raymarcher draws 3D trees, got a {tree.NDIM}D one")
    device = entry_device(device)
    cam = np.ascontiguousarray(camera, _f32).reshape(-1)
    if cam.size != CAMERA_FLOATS:
        raise ValueError(f"a camera is {CAMERA_FLOATS} floats, got {cam.size}")
    if device.type == "cpu":
        out = raymarch_plain(tree, cam, width, height, steps, relax, aa, device, evals)
        return _marched(*out) if evals else out
    counted, looped, edged = _tree_sites(tree) if count else ([], [], [])
    lib = build(tree, "raymarch_sites" if counted or edged else "raymarch", parametric)
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    samples = out if aa == 1 else torch.empty((height * aa, width * aa, 3), dtype=torch.uint8,
                                              device=device)
    check_out(samples, (height * aa, width * aa, 3), torch.uint8, device)
    n_evals = (torch.empty((height * aa, width * aa), dtype=torch.int32, device=device)
               if evals else None)
    queue = torch.empty(1, dtype=torch.int32, device=device)  # the kernel's ray counter
    args = (samples.data_ptr(), out.data_ptr(), None if n_evals is None else n_evals.data_ptr(),
            queue.data_ptr(), cam.ctypes.data, width, height, steps, float(_f32(relax)), aa)
    if counted or edged:
        counts = torch.empty((len(counted) + len(looped) + len(edged), len(_SITE_COUNTS)),
                             dtype=torch.int64, device=device)
        lib.launch("raymarch_sites", device, *args, counts.data_ptr())
        rows = counts.tolist()
        for (site, sub, lo), row in zip(counted, rows):
            skips = ({"member": sub, "bound": "point"} if lo is None
                     else {"subtrahend": sub, "bound": float(lo)})
            total = SHORT_CIRCUITS.setdefault(site, {**skips, **dict.fromkeys(_SITE_COUNTS, 0)})
            for k, v in zip(_SITE_COUNTS, row):
                total[k] += v
        for (loop, member, n), row in zip(looped, rows[len(counted):]):
            total = SHORT_CIRCUITS.setdefault(loop, {"loop": member, "members": n,
                                                     **dict.fromkeys(_LOOP_COUNTS, 0)})
            for k, v in zip(_LOOP_COUNTS, row):
                total[k] += v
        for (fn, n), row in zip(edged, rows[len(counted) + len(looped):]):
            total = EDGE_DIVISIONS.setdefault(fn, {"edges": n, **dict.fromkeys(_EDGE_COUNTS, 0)})
            for k, v in zip(_EDGE_COUNTS, row):
                total[k] += v
    else:
        lib.launch("raymarch", device, *args, tree=tree)
    return _marched(out, n_evals) if evals else out


def _marched(img, n_evals):
    """(img, n_evals), their frame added to MARCH."""
    MARCH["frames"] += 1
    MARCH["rays"] += n_evals.numel()
    MARCH["evaluations"] += int(n_evals.sum())
    return img, n_evals
