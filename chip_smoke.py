#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name, power limit), torch and CUDA
   versions; fails without a CUDA device.
2. Builds every CUDA kernel from the checkout's sources, all nvcc runs
   started together (sm_90a): K1 + K2 per tree, and the four
   tree-independent marching-cubes kernels K3 (compact_active), K4
   (compact_emit), K7s (emit_soup), K7w (emit_welded); prints ptxas'
   registers and spills. Holds K2 (grid eval) and K1 (eval + classify)
   against their plain torch versions: on the nine-type tree of
   the first slice, on a tree holding each of the 55 node types, on
   seeded random CSG trees, and at every main-path grid shape (case grids
   exactly equal, distances within 1e-5 * max(1, |d|)). Holds K3, K4, K7s
   and K7w against theirs on K1's grid of each of those trees: ids, K3's
   three counts (active cubes, crossing edges, triangles), its two block
   offsets and its edge-rank directory, case bytes and tri_idx exactly
   equal, t, soup and welded vertices bit-identical, K7s and K7w in both
   call forms (with K3's result, and running K3 themselves). Holds all six once more on
   the second of flange 800's two fused soup slabs, at its shape and
   plane offset k0. Times every kernel against its plain version with
   CUDA events, in turns (plain, kernel, kernel, plain; K3's library call
   torch.nonzero inside them), at the five main-path grids, beside its
   bound from this run's sizes (gsdf_tpu_torch/bounds.py: the tree's
   operations per corner counted on the CPU, the MC kernels' from their
   plain versions on these inputs) and K1's time over K2's.
3. Drives each FlatRenderer path, every launch count set to 0 just before
   it and read just after (golden triangle counts exact; SDF->STL wall ms,
   median of warm renders after two warm-ups):
   - render_compact + write_binary_stl_indexed (the main path) on flange
     resdiv 400, showerhead 350, flange 800, bolt 300, knurled 350;
   - render() (triangle soup) + write_binary_stl on flange 400, showerhead
     350 and flange 800 (two fused z-slabs);
   - render_indexed() + write_binary_stl_indexed on the same three (flange
     800 through the host weld of the soup);
   - render(fused=False) (the staged path: K2 on the whole grid, k0 = 0)
     on flange 800, equal bit for bit to the two fused slabs' soup;
   - the sphere golden (41,072 triangles, 68^3 evaluations);
   - a part cropped by with_bounds through the fallback: render_compact's
     decoder and the welded emit find unresolved owners, and the mesh is
     the welded soup;
   - render_compact with compact_cubes lowered so that it runs in z-slabs,
     equal to the whole-grid render;
   - evaluate_grid, the dense-field entry point, on three grids.
   Also holds the threaded native mc_decode against the single-threaded
   numpy mc_decode_plain bit for bit on the flange-800 payload.
4. Fails unless each kernel launched on every path that runs it, once per
   render and slab (the wrapper calls counted per render of each path are
   printed and held to what the path should make); prints the device
   launches that torch.profiler sees inside one call of each wrapper, with
   their device time (K7s must be one kernel, K7w at most two), and fails
   unless one soup render
   and one indexed render synchronise once before their fetch
   (torch.cuda.set_sync_debug_mode). A time fails nothing.

The line before the last is nvidia-smi's card name and power limit; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

TOL = 1e-5  # relative to max(1, |d|): a CUDA library ulp vs torch's
#: random_tree seeds whose trees have a surface at resdiv 64 (others are
#: empty intersections, which test nothing)
FUZZ_SEEDS = (0, 3, 4, 5, 7, 9, 14)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError("nvidia-smi printed no card")
    return lines[0].strip()


def nine_type_tree(b, threads):
    """Small tree with the nine node types of the first slice."""
    import numpy as np

    hole = b.new_cylinder(0.2, 3.0)
    holes = [b.translate(hole, np.cos(a), np.sin(a), 0) for a in np.linspace(0, 6, 7)]
    ring = b.union(b.new_cylinder(1.5, 0.5), *holes)
    cut = b.scale(b.difference(b.new_cylinder(1.0, 2.0), b.new_cylinder(0.5, 3.0)), 0.8)
    body = b.intersection(b.smooth_union(0.2, ring, cut), b.new_cylinder(1.8, 1.8, 0.1))
    return b.union(body, threads.screw(b, 2.0, threads.ISO(d=2.0, p=0.4, ext=True)))


def every_type_tree(b, threads, with_bounds, Box):
    """Small tree holding each of the 55 node types of the Builder at
    least once; the 2D types enter through Extrusion and Revolution.
    Takes either package's Builder, threads module, with_bounds and Box,
    so the tests build it through both."""
    t2 = b.translate2d
    profile = b.union2d(
        b.new_circle(0.3),
        t2(b.new_line2d(-0.4, -0.2, 0.5, 0.35, 0.1), 0.1, 0.1),
        b.new_lines2d([[(-0.5, 0), (0, 0.3)], [(0, 0.3), (0.5, -0.2)]], 0.08),
        b.new_arc(0.6, math.pi / 1.5, 0.08),
        b.rotate2d(b.new_equilateral_triangle(0.5), 0.3),
        b.difference2d(b.new_rectangle(1.0, 0.6), b.new_hexagon(0.2)),
        b.intersection2d(b.new_octagon(0.7), b.new_ellipse(0.8, 0.45)),
        b.xor2d(b.new_diamond2d(1.0, 0.6), b.new_rounded_x(1.0, 0.1)),
        b.new_quadratic_bezier2d((-0.5, -0.2), (0.1, 0.6), (0.6, -0.1), 0.1),
        b.new_polygon([(-0.5, -0.4), (0.5, -0.5), (0.4, 0.5), (-0.3, 0.35)]),
        t2(b.array2d(b.new_circle(0.1), 0.3, 0.3, 2, 2), -0.6, -0.6),
        b.offset2d(b.new_circle(0.2), 0.02),
        b.symmetry2d(t2(b.new_circle(0.1), 0.5, 0.2), True, True),
        b.annulus(b.new_circle(0.5), 0.05),
        b.circular_array2d(t2(b.new_rectangle(0.1, 0.05), 0.7, 0), 5, 6),
        b.scale2d(b.new_hexagon(0.2), 1.5),
        b.translate_multi2d(b.new_circle(0.1), [(0, 0.5), (0.3, -0.5)]),
        b.elongate2d(b.new_circle(0.1), 0.3, 0.1),
        with_bounds(b.new_circle(0.2), Box([-0.2, -0.2], [0.2, 0.2])),
    )
    box = b.new_box(0.8, 0.6, 0.5, 0.05)
    ball = b.new_sphere(0.4)
    parts = [
        b.translate(b.extrude(profile, 0.4), 0, 0, 1.6),
        b.translate(b.revolve(t2(b.new_rectangle(0.3, 0.4), 0.9, 0), 0.1), 0, 0, -1.6),
        b.translate(b.xor(box, ball), 2.0, 0, 0),
        b.translate(b.new_box_frame(0.9, 0.8, 0.7, 0.1), -2.0, 0, 0),
        b.translate(b.new_torus(0.8, 0.2), 0, 2.0, 0),
        b.translate(b.new_hexagonal_prism(0.4, 0.3), 0, -2.0, 0),
        b.translate(b.smooth_union(0.1, b.new_cylinder(0.3, 0.8, 0.05), ball), 2.0, 2.0, 0),
        b.translate(b.smooth_difference(0.1, box, ball), -2.0, 2.0, 0),
        b.translate(b.smooth_intersect(0.1, box, b.new_sphere(0.45)), 2.0, -2.0, 0),
        b.translate(b.scale(b.difference(box, ball), 0.7), -2.0, -2.0, 0),
        b.translate(b.symmetry(b.translate(ball, 0.3, 0.2, 0), True, True, False), 0, 0, 3.2),
        b.translate(b.rotate(box, 0.7, (1, 0.3, 0.2)), 2.0, 0, 1.5),
        b.translate(b.offset(b.intersection(box, b.new_sphere(0.5)), -0.02), -2.0, 0, 1.5),
        b.translate(b.array(b.new_sphere(0.15), 0.4, 0.4, 0.4, 2, 2, 2), 0, 2.0, 1.5),
        b.translate(b.elongate(b.new_sphere(0.2), 0.3, 0.2, 0.1), 0, -2.0, 1.5),
        b.translate(b.shell(b.new_sphere(0.4), 0.05), 2.0, 0, -1.5),
        b.translate(
            b.circular_array(b.translate(b.new_box(0.2, 0.1, 0.3, 0), 0.6, 0, 0), 5, 7),
            -2.0, 0, -1.5,
        ),
        b.translate(b.twist(b.new_box(0.8, 0.3, 0.8, 0), 0.8), 0, 2.0, -1.5),
        b.translate(
            with_bounds(b.new_sphere(0.4), Box([-0.3, -0.3, -0.3], [0.3, 0.3, 0.3])),
            0, -2.0, -1.5,
        ),
        b.translate(threads.screw(b, 1.0, threads.ISO(d=1.2, p=0.25, ext=True)), 0, 0, -3.2),
    ]
    return b.union(*parts)


def random_tree(b, rng):
    """A seeded random CSG tree for the card: random primitives (2D
    profiles extruded or revolved) combined by the boolean and smooth
    ops, then one or two random domain ops, as the JAX package's path
    fuzz builds them (tests/test_fuzz_paths.py). None when the Builder
    rejects the draw."""
    def profile():
        k = int(rng.integers(3))
        if k == 0:
            return b.new_circle(float(rng.uniform(0.2, 0.5)))
        if k == 1:
            return b.new_rectangle(float(rng.uniform(0.3, 0.8)), float(rng.uniform(0.3, 0.8)))
        return b.new_hexagon(float(rng.uniform(0.2, 0.5)))

    prims = [
        lambda: b.new_sphere(float(rng.uniform(0.3, 1.0))),
        lambda: b.new_box(*(float(x) for x in rng.uniform(0.4, 1.2, 3)), 0.0),
        lambda: b.new_cylinder(float(rng.uniform(0.2, 0.6)), float(rng.uniform(0.5, 1.5)), 0.0),
        lambda: b.new_torus(float(rng.uniform(0.5, 0.9)), float(rng.uniform(0.1, 0.25))),
        lambda: b.new_hexagonal_prism(float(rng.uniform(0.3, 0.7)), float(rng.uniform(0.4, 1.0))),
        lambda: b.extrude(profile(), float(rng.uniform(0.4, 1.2))),
        lambda: b.revolve(b.translate2d(profile(), float(rng.uniform(0.8, 1.5)), 0.0),
                          float(rng.uniform(0.0, 0.4))),
    ]

    def leaf():
        s = prims[int(rng.integers(len(prims)))]()
        return b.translate(s, *(float(x) for x in rng.uniform(-0.5, 0.5, 3)))

    def unary(t):
        k = int(rng.integers(8))
        if k == 0:
            ax = rng.normal(size=3)
            ax /= math.sqrt(float((ax * ax).sum()))
            return b.rotate(t, float(rng.uniform(0, 3)), tuple(float(a) for a in ax))
        if k == 1:
            return b.scale(t, float(rng.uniform(0.6, 1.5)))
        if k == 2:
            return b.shell(t, float(rng.uniform(0.03, 0.1)))
        if k == 3:
            return b.twist(t, float(rng.uniform(-0.5, 0.5)))
        if k == 4:
            n_div = int(rng.integers(3, 9))
            return b.circular_array(b.translate(t, float(rng.uniform(1.5, 2.5)), 0.0, 0.0),
                                    int(rng.integers(2, n_div + 1)), n_div)
        if k == 5:
            return b.elongate(t, *(float(x) for x in rng.uniform(0.05, 0.4, 3)))
        if k == 6:
            return b.symmetry(t, True, bool(rng.integers(2)), False)
        nx, ny, nz = (int(x) for x in rng.integers(1, 3, 3))
        return b.array(t, *(float(x) for x in rng.uniform(1.8, 2.4, 3)), nx, ny, nz)

    ops = [b.union, b.difference, b.intersection,
           lambda x, y: b.smooth_union(float(rng.uniform(0.02, 0.2)), x, y),
           lambda x, y: b.smooth_difference(float(rng.uniform(0.02, 0.2)), x, y)]
    t = leaf()
    for _ in range(int(rng.integers(1, 4))):
        t = ops[int(rng.integers(len(ops)))](t, leaf())
    for _ in range(int(rng.integers(1, 3))):
        t = unary(t)
    if b.err():
        return None
    bb = t.bounds()
    if bb.is_empty() or not math.isfinite(bb.diagonal()):
        return None
    return t


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn over `reps` launches after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grid_of(tree, resdiv, dev, slab):
    """(renderer, corner shape, k0) of the whole grid at diag/resdiv, or of
    its fused soup slab number `slab` (FlatRenderer.soup_slabs)."""
    from gsdf_tpu_torch.render.flat import FlatRenderer

    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
    if slab is None:
        return fr, fr.shape(), 0
    k0, shape = fr.soup_slabs()[slab]
    return fr, shape, k0


def compare(name, tree, resdiv, dev, gk, slab=None):
    """K2 and K1 vs their plain versions on one grid (or soup slab, at its
    plane offset k0); returns the max absolute error of each and raises on
    a disagreement."""
    import torch

    fr, shape, k0 = grid_of(tree, resdiv, dev, slab)
    d2 = gk.evaluate_grid(tree, fr.origin, fr.res, shape, dev, k0)
    d1, c1 = gk.classified_grid(tree, fr.origin, fr.res, shape, dev, k0)
    pd, pc = gk.classified_grid_plain(tree, fr.origin, fr.res, shape, dev, k0)
    torch.cuda.synchronize()
    out = {}
    for kname, d in (("grid_eval", d2), ("classified_grid", d1)):
        if not bool(torch.isfinite(d).all()):
            raise RuntimeError(f"{kname} {name}: non-finite distances")
        diff = (d - pd).abs()
        rel = float((diff / pd.abs().clamp(min=1.0)).max())
        out[kname] = float(diff.max())
        log(
            f"  {kname:15s} {name:14s} grid {shape} k0 {k0}: max|d-plain| {out[kname]:.3e} "
            f"(rel {rel:.3e}), differing floats {int((diff > 0).sum())} of {d.numel()}"
        )
        if rel > TOL:
            raise RuntimeError(f"{kname} {name}: distances off by {rel:.3e} > {TOL}")
    n_case_diff = int((c1 != pc).sum())
    log(
        f"  classified_grid {name:14s} cases: {n_case_diff} differing of {c1.numel()}, "
        f"{int((c1 != 0).sum())} active"
    )
    if n_case_diff:
        raise RuntimeError(f"classified_grid {name}: case grid differs from plain")
    if not torch.equal(d1, d2):
        raise RuntimeError(f"{name}: K1 and K2 distances differ")
    return out


#: the main-path grids, where every kernel is timed
MAIN_GRIDS = (("flange", 400), ("showerhead", 350), ("flange", 800), ("bolt", 300),
              ("knurled", 350))
#: (name, route source, replaced TPU-side function "file:line")
KERNELS = (
    ("classified_grid", "gsdf_tpu_torch/csrc/classified_grid.cu",
     "gsdf_tpu/eval/pallas_grid.py:187"),
    ("grid_eval", "gsdf_tpu_torch/csrc/grid_eval.cu", "gsdf_tpu/eval/pallas_grid.py:108"),
    ("compact_active", "gsdf_tpu_torch/csrc/compact_active.cu", "gsdf_tpu/ops/mc_emit.py:190"),
    ("compact_emit", "gsdf_tpu_torch/csrc/compact_emit.cu",
     "gsdf_tpu/ops/compact_field.py:217"),
    ("emit_soup", "gsdf_tpu_torch/csrc/emit_soup.cu", "gsdf_tpu/ops/mc_emit.py:332"),
    ("emit_welded", "gsdf_tpu_torch/csrc/emit_welded.cu",
     "gsdf_tpu/ops/fused_welded.py:43"),
)


def mc_versions(dist, cases, comp, fr, k0=0):
    """(kernel, plain) callables of K3, K4, K7s and K7w on one grid whose
    first plane is plane k0 of the whole grid; comp is K3's result with
    its edge ranks (None where only K3 is called). The emit kernels take
    K3's counts and block offsets, as the paths hand them on."""
    from gsdf_tpu_torch.ops import compact_field, fused_welded, mc_emit

    o, r = fr.origin, fr.res
    ids = None if comp is None else comp.ids
    return {
        "compact_active": (lambda: mc_emit.compact_active(cases),
                           lambda: mc_emit.compact_active_plain(cases)),
        "compact_emit": (lambda: compact_field.compact_emit(dist, cases, ids, comp.n_t,
                                                            comp.offsets),
                         lambda: compact_field.compact_emit_plain(dist, cases, ids)),
        "emit_soup": (lambda: mc_emit.emit_triangles(dist, cases, ids, o, r, k0, comp.n_tris,
                                                     comp.tri_offsets),
                      lambda: mc_emit.emit_triangles_plain(dist, cases, ids, o, r, k0)),
        "emit_welded": (lambda: fused_welded.emit_welded(dist, cases, ids, o, r, k0, comp=comp),
                        lambda: fused_welded.emit_welded_plain(dist, cases, ids, o, r, k0)),
    }


def _max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_compaction(a, b) -> bool:
    """Two results of K3 equal in every field both hold."""
    import torch

    return (torch.equal(a.ids, b.ids) and (a.n_t, a.n_tris) == (b.n_t, b.n_tris)
            and torch.equal(a.offsets, b.offsets) and torch.equal(a.tri_offsets, b.tri_offsets)
            and (a.edge_ranks is None or b.edge_ranks is None
                 or torch.equal(a.edge_ranks, b.edge_ranks)))


def mc_compare(name, tree, resdiv, dev, gk, slab=None):
    """K3, K4, K7s and K7w vs their plain versions on K1's grid (or soup
    slab, at its plane offset k0): ids, K3's counts, block offsets and edge
    ranks, case bytes and tri_idx exact, t and vertices bit-identical; K7s
    and K7w also in the form that runs K3 itself. Returns the max absolute
    error of each kernel's output, the grid, K3's result, the renderer and
    the output sizes (for timing and bounds); raises on a disagreement."""
    import torch
    from gsdf_tpu_torch.ops import fused_welded, mc_emit

    fr, shape, k0 = grid_of(tree, resdiv, dev, slab)
    dist, cases = gk.classified_grid(tree, fr.origin, fr.res, shape, dev, k0)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    ref_comp = mc_emit.compact_active_plain(cases, edge_ranks=True)
    fns = mc_versions(dist, cases, comp, fr, k0)
    bare = fns["compact_active"][0]()  # as the soup and compact paths call it
    (idx8, t), (ref_idx8, ref_t) = (f() for f in fns["compact_emit"])
    tris, ref_tris = (f() for f in fns["emit_soup"])
    (verts, tri, unres), (ref_verts, ref_tri, ref_unres) = (f() for f in fns["emit_welded"])
    ids = comp.ids
    tris3 = mc_emit.emit_triangles(dist, cases, ids, fr.origin, fr.res, k0)
    verts3, tri3, unres3 = fused_welded.emit_welded(dist, cases, ids, fr.origin, fr.res, k0)
    torch.cuda.synchronize()
    unres, ref_unres = int(unres), int(ref_unres)
    checks = {
        "compact_active": (same_compaction(comp, ref_comp) and same_compaction(bare, ref_comp)
                           and bare.edge_ranks is None
                           and (comp.n_t, comp.n_tris) == (len(ref_verts), len(ref_tris)),
                           max(_max_abs(ids, ref_comp.ids),
                               _max_abs(comp.offsets, ref_comp.offsets),
                               _max_abs(comp.tri_offsets, ref_comp.tri_offsets),
                               _max_abs(comp.edge_ranks, ref_comp.edge_ranks))),
        "compact_emit": (torch.equal(idx8, ref_idx8) and torch.equal(t, ref_t),
                         max(_max_abs(t, ref_t), _max_abs(idx8, ref_idx8))),
        "emit_soup": (torch.equal(tris, ref_tris) and torch.equal(tris3, ref_tris),
                      _max_abs(tris, ref_tris)),
        "emit_welded": (torch.equal(verts, ref_verts) and torch.equal(tri, ref_tri)
                        and unres == ref_unres and torch.equal(verts3, ref_verts)
                        and torch.equal(tri3, ref_tri) and int(unres3) == ref_unres,
                        max(_max_abs(verts, ref_verts), _max_abs(tri, ref_tri))),
    }
    log(f"  MC kernels {name:14s}: {len(ids)} active, {comp.n_t} t, {len(tris)} triangles, "
        f"{len(verts)} welded vertices, {unres} unresolved corners; "
        + ", ".join(f"{k} {'exact' if ok else 'DIFFERS'}" for k, (ok, _) in checks.items()))
    bad = [k for k, (ok, _) in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{name}: {bad} differ from their plain versions")
    sizes = {"corners": dist.numel(), "cubes": cases.numel(), "active": len(ids),
             "n_t": len(t), "tris": len(tris), "verts": len(verts)}
    return {k: err for k, (_, err) in checks.items()}, (dist, cases, comp, fr, sizes)


def device_launches(fn) -> dict:
    """What torch.profiler sees on the card inside one call of fn: kernels,
    memsets and copies by count, and their device time summed (ms): the
    call's time with the host's share taken out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "memsets": 0, "copies": 0, "device_ms": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = ("memsets" if "memset" in e.name.lower()
                    else "copies" if "memcpy" in e.name.lower() else "kernels")
            out[kind] += 1
            out["device_ms"] += e.time_range.elapsed_us() / 1e3
    return out


def synchronising(fn):
    """(fn's result, the synchronising calls torch warned of inside it)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]


def counted(kernels, expected, fn):
    """Run fn with every launch count at 0; fail unless each kernel in
    `expected` launched. Returns (fn's result, the counts read just after)."""
    kernels.reset_launches()
    out = fn()
    counts = dict(kernels.LAUNCHES)
    missing = [k for k in expected if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels {missing} were not launched on their path: {counts}")
    return out, counts


def cropped_part(b, with_bounds, Box):
    """A part cropped by with_bounds so that its surface crosses the
    render box's far faces: owner cubes there lie outside the grid, and
    the compact decoder and the welded emit cannot resolve them."""
    body = b.union(b.new_sphere(1.0), b.translate(b.new_box(0.5, 0.5, 2.5, 0.05), 0.3, 0.2, 0))
    return with_bounds(body, Box([-0.62] * 3, [0.62] * 3))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from gsdf_tpu_torch import (
            Builder, Flags, bounds, cli, flagships, kernels, native, with_bounds,
        )
        from gsdf_tpu_torch.eval import grid_kernels as gk
        from gsdf_tpu_torch.forge import threads
        from gsdf_tpu_torch.geometry.boxes import Box
        from gsdf_tpu_torch.ops import fused_welded, mc_emit
        from gsdf_tpu_torch.ops.compact_field import compact_field_render
        from gsdf_tpu_torch.render.flat import FlatRenderer
    except ImportError as e:
        print(f"chip_smoke: gsdf_tpu_torch not importable ({e}); run it in the "
              "repository root", file=sys.stderr)
        return 3
    import numpy as np

    # --- phase 1: the card -------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # --- phase 2: build, compare, time ---------------------------------
    trees = {
        "nine-types": nine_type_tree(Builder(), threads),
        "every-type": every_type_tree(Builder(), threads, with_bounds, Box),
        "flange": flagships.build_flange(),
        "showerhead": flagships.build_showerhead(),
        "bolt": flagships.build_bolt(),
        "knurled": flagships.build_knurled(),
        "cropped": cropped_part(Builder(), with_bounds, Box),
    }
    for seed in FUZZ_SEEDS:
        tree = random_tree(Builder(Flags.NO_DIMENSION_PANIC), np.random.default_rng(seed))
        if tree is not None:
            trees[f"fuzz{seed}"] = tree
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(trees) + len(kernels.STATIC_KERNELS)) as pool:
        futs = [pool.submit(gk.build, tree) for tree in trees.values()]
        futs += [pool.submit(kernels.static_lib, n) for n in kernels.STATIC_KERNELS]
        for fut in futs:
            fut.result()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {len(futs)} kernel libraries ({len(trees)} trees + "
        f"{len(kernels.STATIC_KERNELS)} MC kernels; one nvcc each, in parallel) "
        f"in {build_s:.1f} s")
    logs = [(name, gk.build_log(tree)) for name, tree in trees.items()]
    logs += [(name, kernels.static_build_log(name)) for name in kernels.STATIC_KERNELS]
    for name, text in logs:
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain torch on the card")
    max_err = {name: 0.0 for name, _, _ in KERNELS}
    grids = [("nine-types", 60), ("every-type", 90), ("cropped", 40)]
    grids += [(name, 64) for name in trees if name.startswith("fuzz")]
    grids += [("flange", 100), *MAIN_GRIDS]
    mc_inputs = {}
    # flange 800's soup runs two fused slabs: the second, at its shape and
    # plane offset k0, holds K1, K3, K7s (and K4, K7w) at k0 != 0
    slabs = [("flange", 800, 1)]
    for name, resdiv, slab in [(n, r, None) for n, r in grids] + slabs:
        label = f"{name}@{resdiv}" + ("" if slab is None else f" slab {slab}")
        errs = compare(label, trees[name], resdiv, dev, gk, slab)
        mc_errs, inputs = mc_compare(label, trees[name], resdiv, dev, gk, slab)
        errs.update(mc_errs)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)
        if slab is None and (name, resdiv) in MAIN_GRIDS:
            mc_inputs[(name, resdiv)] = inputs
        del inputs

    # bounds: the tree's operations per corner, counted on the CPU
    ops_per_point = {name: bounds.tree_ops_per_point(trees[name])
                     for name in dict.fromkeys(n for n, _ in MAIN_GRIDS)}
    log(f"  tree operations per corner (plain torch on the CPU): {ops_per_point}")
    times = {}
    for name, resdiv in MAIN_GRIDS:
        tree = trees[name]
        dist, cases, comp, fr, sizes = mc_inputs.pop((name, resdiv))
        args = (tree, fr.origin, fr.res, fr.shape(), dev)
        versions = {
            "classified_grid": (lambda: gk.classified_grid(*args),
                                lambda: gk.classified_grid_plain(*args)),
            "grid_eval": (lambda: gk.evaluate_grid(*args), lambda: gk.evaluate_grid_plain(*args)),
            **mc_versions(dist, cases, comp, fr),
        }
        # one PyTorch call that computes the same function, timed as a
        # yardstick (the port never calls it); the other kernels have none
        library = {"compact_active": lambda: torch.nonzero(cases.reshape(-1))}
        tree_ops = ops_per_point[name] * sizes["corners"]
        ops = {"grid_eval": tree_ops,
               "classified_grid": tree_ops + bounds.count_ops(
                   mc_emit.effective_cases, dist, fr.res)[1]}
        row = {}
        for k, (kernel, plain) in versions.items():
            if k not in ops:
                ops[k] = bounds.count_ops(plain)[1]  # the plain version on these inputs
            lib = library.get(k)
            # plain, (library), kernel, kernel, (library), plain: in turns
            p1 = cuda_ms(plain, 3)
            l1 = cuda_ms(lib, 10) if lib else None
            k1, k2 = cuda_ms(kernel, 10), cuda_ms(kernel, 10)
            l2 = cuda_ms(lib, 10) if lib else None
            ms = min(k1, k2)
            b = bounds.bound(ops[k], bounds.kernel_bytes(k, **sizes))
            row[k] = {"ms": ms, "plain_ms": min(p1, cuda_ms(plain, 3)),
                      "library_ms": min(l1, l2) if lib else None, **b,
                      "share": b["bound_ms"] / ms,
                      "published_fp32_share": b["published_fp32_ms"] / ms}
        # K3 as the indexed path calls it, with K7w's edge-rank directory
        def with_ranks():
            return mc_emit.compact_active(cases, edge_ranks=True)

        row["compact_active"]["with_edge_ranks_ms"] = min(cuda_ms(with_ranks, 10),
                                                          cuda_ms(with_ranks, 10))
        row["k1_over_k2"] = row["classified_grid"]["ms"] / row["grid_eval"]["ms"]
        times[f"{name}@{resdiv}"] = row
        log(f"  device ms {name}@{resdiv} grid {fr.shape()}: "
            + ", ".join(f"{k} {v['ms']:.3f} (bound {v['bound_ms']:.3f} by {v['bound_by']}, "
                        f"share {v['share']:.2f}, plain {v['plain_ms']:.3f}"
                        + (f", library {v['library_ms']:.3f})" if v["library_ms"] else ")")
                        for k, v in row.items() if k != "k1_over_k2")
            + f"; K3 with edge ranks {row['compact_active']['with_edge_ranks_ms']:.3f}"
            + f"; K1/K2 {row['k1_over_k2']:.3f}  [{card}]")
        # the device launches inside one call of each wrapper, and their time
        for k, (kernel, _) in versions.items():
            row[k]["on_device"] = device_launches(kernel)
        inside = {k: {n: v for n, v in row[k]["on_device"].items() if n != "device_ms"}
                  for k in versions}
        log(f"  on the card inside one wrapper call ({name}@{resdiv}): "
            + ", ".join(f"{k} {row[k]['on_device']}" for k in versions))
        one_kernel = {"kernels": 1, "memsets": 0, "copies": 0}
        if inside["emit_soup"] != one_kernel or inside["compact_emit"] != one_kernel:
            raise RuntimeError(f"K7s and K4 should be one kernel launch and nothing else: {inside}")
        if inside["emit_welded"]["kernels"] > 2 or inside["emit_welded"]["copies"]:
            raise RuntimeError(f"K7w should be at most two launches and copy nothing: {inside}")
        del dist, cases, comp
    torch.cuda.empty_cache()

    # --- phases 3 and 4: each path, counts from 0 around each run -------
    launches = {k: 0 for k in kernels.LAUNCHES}
    e2e = {}
    per_render = {}  # launches per render of each kernel, per path and part

    def run(label, expected, fn):
        out, counts = counted(kernels, expected, fn)
        for k, n in counts.items():
            launches[k] += n
        log(f"phase 3: {label}: launches {counts}")
        return out, counts

    compact_path = ("classified_grid", "compact_active", "compact_emit")
    soup_path = ("classified_grid", "compact_active", "emit_soup")
    welded_path = ("classified_grid", "compact_active", "emit_welded")
    goldens = {
        ("flange", 400): flagships.GOLDEN_FLANGE_TRIS,
        ("showerhead", 350): flagships.GOLDEN_SHOWERHEAD_TRIS,
        ("flange", 800): flagships.GOLDEN_FLANGE_800_TRIS,
        ("bolt", 300): flagships.GOLDEN_BOLT_TRIS,
        ("knurled", 350): flagships.GOLDEN_KNURLED_TRIS,
    }
    benches = [("compact", compact_path, name, resdiv, 5) for name, resdiv in MAIN_GRIDS]
    for name, resdiv in MAIN_GRIDS[:3]:
        benches.append(("soup", soup_path, name, resdiv, 3))
        via_weld = name == "flange" and resdiv == 800  # past slab_cubes
        benches.append(("indexed", soup_path if via_weld else welded_path, name, resdiv, 3))
    for path, expected, name, resdiv, reps in benches:
        golden = goldens[(name, resdiv)]
        (ms, ntris, all_ms), counts = run(
            f"{path} {name}@{resdiv}", expected,
            lambda: cli.bench_part(trees[name], resdiv, golden, reps, dev, path),
        )
        e2e[f"{path} {name}@{resdiv}"] = ms
        per_render[f"{path} {name}@{resdiv}"] = {
            k: n / (reps + 2) for k, n in counts.items() if n}  # two warm-ups + reps
        slabs = 2 if (name, resdiv) == ("flange", 800) and path != "compact" else 1
        if per_render[f"{path} {name}@{resdiv}"] != {k: slabs for k in expected}:
            raise RuntimeError(f"{path} {name}@{resdiv}: expected one call of each of {expected} "
                               f"per render and slab, got {per_render[f'{path} {name}@{resdiv}']}")
        log(f"phase 3: {path} {name} resdiv {resdiv}: {ntris} triangles (golden {golden}), "
            f"SDF->STL warm median {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in all_ms)}) "
            f"[{card}]")

    f800 = trees["flange"]
    res800 = f800.bounds().diagonal() / 800
    soup, counts = run("render() flange@800, one render", soup_path,
                       lambda: FlatRenderer(f800, res800, dev).render())
    if counts["classified_grid"] != 2 or counts["emit_soup"] != 2:
        raise RuntimeError(f"flange 800's soup should run two fused slabs: {counts}")
    # the staged path evaluates the whole grid with K2 and emits at k0 = 0:
    # a slab offset dropped or misapplied in K1 or K7s shows as a difference
    staged, counts = run("staged render(fused=False) flange@800, one whole grid",
                         ("grid_eval", "compact_active", "emit_soup"),
                         lambda: FlatRenderer(f800, res800, dev).render(fused=False))
    per_render["staged flange@800"] = {k: n for k, n in counts.items() if n}
    if len(soup) != flagships.GOLDEN_FLANGE_800_TRIS or not np.array_equal(staged, soup):
        raise RuntimeError("flange 800's two fused slabs differ from the staged whole-grid soup")
    log(f"phase 3: flange@800: the two fused slabs' soup equals the staged whole-grid soup "
        f"bit for bit ({len(staged)} triangles)")
    del staged
    (verts, tri), counts = run("render_indexed() flange@800, one render", soup_path,
                               lambda: FlatRenderer(f800, res800, dev).render_indexed())
    if counts["emit_welded"] or len(tri) != len(soup) or not np.array_equal(verts[tri], soup):
        raise RuntimeError("flange 800's render_indexed is not the host weld of its soup")
    del soup, verts, tri

    f400 = trees["flange"]
    res400 = f400.bounds().diagonal() / 400

    # one synchronising read (K3's counts) before the fetch, and one fetch
    fr = FlatRenderer(f400, res400, dev)
    grid_args = (f400, fr.origin, fr.res, fr.shape(), dev)

    def emitted(indexed):
        dist, cases = gk.classified_grid(*grid_args)
        comp = mc_emit.compact_active(cases, edge_ranks=indexed)
        if indexed:
            return fused_welded.emit_welded(dist, cases, comp.ids, fr.origin, fr.res, comp=comp)
        return mc_emit.emit_triangles(dist, cases, comp.ids, fr.origin, fr.res, 0, comp.n_tris,
                                      comp.tri_offsets)

    for label, until_fetch, whole in (
        ("soup", lambda: emitted(False), lambda: FlatRenderer(f400, res400, dev).render()),
        ("indexed", lambda: emitted(True), lambda: fused_welded.welded_render(*grid_args)),
    ):
        _, before = synchronising(until_fetch)
        _, render_syncs = synchronising(whole)
        log(f"phase 3: {label} flange@400: {len(before)} synchronising call before the fetch, "
            f"{len(render_syncs)} in a whole render (K3's count read, then the fetch)")
        if len(before) != 1 or len(render_syncs) != 2:
            raise RuntimeError(f"{label}: expected one read before the fetch and one fetch: "
                               f"{before} / {render_syncs}")

    sphere = Builder().new_sphere(1.0)
    sfr = FlatRenderer(sphere, 1.0 / 33, dev)
    tris, _ = run("sphere r=1 @ r/33 render()", soup_path, sfr.render)
    if len(tris) != 41072 or sfr.evaluations() != 68**3:
        raise RuntimeError(f"sphere golden: {len(tris)} != 41072 or {sfr.evaluations()} "
                           "evaluations != 68^3")
    log(f"phase 3: sphere golden: {len(tris)} triangles, {sfr.evaluations()} evaluations")

    cropped = trees["cropped"]
    cres = cropped.bounds().diagonal() / 40
    (verts, tri), _ = run("cropped part render_compact (fallback)",
                          compact_path + ("emit_welded", "emit_soup"),
                          lambda: FlatRenderer(cropped, cres, dev).render_compact())
    csoup = FlatRenderer(cropped, cres, dev).render()
    if tri.max() >= len(verts) or not np.array_equal(verts[tri], csoup):
        raise RuntimeError("the cropped part's fallback mesh is not its welded soup")
    log(f"phase 3: cropped part: fallback to the welded soup, {len(tri)} triangles, "
        f"{len(verts)} vertices")

    whole = FlatRenderer(f400, res400, dev)
    wv, wt = whole.render_compact()
    sl = FlatRenderer(f400, res400, dev)
    sl.compact_cubes = -(-sl.shape()[0] // 3) * sl.shape()[1] * sl.shape()[2]
    (sv, st), counts = run("slabbed render_compact flange@400", compact_path, sl.render_compact)
    if counts["classified_grid"] < 3 or not (np.array_equal(st, wt) and np.array_equal(sv, wv)):
        raise RuntimeError(f"the slabbed compact render differs from the whole grid's: {counts}")
    log(f"phase 3: slabbed compact flange@400: {counts['classified_grid']} slabs, equal to "
        f"the whole-grid render ({len(st)} triangles)")
    del wv, wt, sv, st

    for name, resdiv in (("flange", 400), ("bolt", 300), ("knurled", 350)):
        tree = trees[name]
        fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)

        def dense():
            field = gk.evaluate_grid(tree, fr.origin, fr.res, fr.shape(), dev)
            torch.cuda.synchronize()
            return field

        field, counts = run(f"evaluate_grid {name}@{resdiv}", ("grid_eval",), dense)
        per_render[f"evaluate_grid {name}@{resdiv}"] = {k: n for k, n in counts.items() if n}
        if not bool(torch.isfinite(field).all()):
            raise RuntimeError(f"evaluate_grid: non-finite distances on {name}")
        del field
    log(f"phase 4: kernel launches over the paths: {launches}")

    fr = FlatRenderer(f800, res800, dev)
    payload = compact_field_render(f800, fr.origin, fr.res, fr.shape(), dev)
    args = (*payload, fr.nx, fr.ny, fr.nz, fr.origin, fr.res)
    t0 = time.perf_counter()
    v_nat, tri_nat = native.mc_decode(*args)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    v_np, tri_np = native.mc_decode_plain(*args)
    np_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(tri_nat, tri_np) and np.array_equal(v_nat, v_np)):
        raise RuntimeError("threaded native mc_decode differs from mc_decode_plain")
    log(f"decode pin: native mc_decode ({os.cpu_count()} host cores) == numpy "
        f"mc_decode_plain bit for bit on flange 800 ({len(tri_nat)} triangles); "
        f"{nat_ms:.1f} ms vs {np_ms:.1f} ms")

    t400 = times["flange@400"]
    line = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": t400[name]["ms"],
            "plain_ms": t400[name]["plain_ms"],
            "bound_ms": t400[name]["bound_ms"],
            "bound_by": t400[name]["bound_by"],
            "library_ms": t400[name]["library_ms"],
            "share": t400[name]["share"],
            "launches_per_render": {
                path: per_render[f"{path} flange@400"].get(name, 0)
                for path in ("compact", "soup", "indexed")
            },
            "on_device_per_call": t400[name]["on_device"],
        }
        for name, source, replaces in KERNELS
    ]
    log(json.dumps({"build_s": build_s, "device_ms": times, "sdf_to_stl_ms": e2e,
                    "launches_per_render": per_render}))
    log(json.dumps({"kernels": line}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.exit(rc)
