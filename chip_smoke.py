#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name, power limit), torch and CUDA
   versions; fails without a CUDA device.
2. Builds the CUDA kernels of every tree from the checkout's sources
   (one nvcc per tree, all started together; sm_90a) and prints ptxas'
   registers and spills per tree. Holds K2 (grid eval) and K1 (fused
   eval + classify) against their plain torch versions on the card: on
   the nine-type tree of the first slice, on a tree holding each of the
   55 node types, on seeded random CSG trees, and at every main-path grid
   shape: case grids exactly equal, distances within 1e-5 * max(1, |d|).
   Times each kernel against its plain version with CUDA events.
3. Drives the main path, each part with every launch count set to 0 just
   before it and read just after: FlatRenderer.render_compact +
   write_binary_stl_indexed on flange resdiv 400, showerhead resdiv 350,
   flange resdiv 800, bolt resdiv 300 and knurled cylinder resdiv 350
   (golden triangle counts, exact; median warm ms after two warm-ups);
   then evaluate_grid, the dense-field entry point, on the flange-400,
   bolt-300 and knurled-350 grids.
4. Fails unless each kernel launched on every path that runs it.

The line before the last is nvidia-smi's card name and power limit; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line.
"""
from __future__ import annotations

import json
import math
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


def compare(name, tree, resdiv, dev, gk):
    """K2 and K1 vs their plain versions on one grid; returns the max
    absolute error of each and raises on a disagreement."""
    import torch

    from gsdf_tpu_torch.render.flat import FlatRenderer

    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
    shape = fr.shape()
    d2 = gk.evaluate_grid(tree, fr.origin, fr.res, shape, dev)
    d1, c1 = gk.classified_grid(tree, fr.origin, fr.res, shape, dev)
    pd, pc = gk.classified_grid_plain(tree, fr.origin, fr.res, shape, dev)
    torch.cuda.synchronize()
    out = {}
    for kname, d in (("grid_eval", d2), ("classified_grid", d1)):
        if not bool(torch.isfinite(d).all()):
            raise RuntimeError(f"{kname} {name}: non-finite distances")
        diff = (d - pd).abs()
        rel = float((diff / pd.abs().clamp(min=1.0)).max())
        out[kname] = float(diff.max())
        log(
            f"  {kname:15s} {name:14s} grid {shape}: max|d-plain| {out[kname]:.3e} "
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


def counted(gk, kernel, fn):
    """Run fn with every launch count at 0; fail unless `kernel` launched.
    Returns (fn's result, the counts read just after)."""
    gk.reset_launches()
    out = fn()
    counts = dict(gk.LAUNCHES)
    if counts[kernel] <= 0:
        raise RuntimeError(f"kernel {kernel} was not launched on its path")
    return out, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from gsdf_tpu_torch import Builder, Flags, cli, flagships, with_bounds
        from gsdf_tpu_torch.eval import grid_kernels as gk
        from gsdf_tpu_torch.forge import threads
        from gsdf_tpu_torch.geometry.boxes import Box
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
    }
    for seed in FUZZ_SEEDS:
        tree = random_tree(Builder(Flags.NO_DIMENSION_PANIC), np.random.default_rng(seed))
        if tree is not None:
            trees[f"fuzz{seed}"] = tree
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        for fut in [pool.submit(gk.build, tree) for tree in trees.values()]:
            fut.result()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {len(trees)} kernel libraries (one nvcc each, in parallel) "
        f"in {build_s:.1f} s")
    for name, tree in trees.items():
        for line in gk.build_log(tree).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain torch on the card")
    max_err = {"grid_eval": 0.0, "classified_grid": 0.0}
    grids = [("nine-types", 60), ("every-type", 90)]
    grids += [(name, 64) for name in trees if name.startswith("fuzz")]
    grids += [("flange", 100), ("flange", 400), ("showerhead", 350), ("flange", 800),
              ("bolt", 300), ("knurled", 350)]
    for name, resdiv in grids:
        errs = compare(f"{name}@{resdiv}", trees[name], resdiv, dev, gk)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)

    times = {}
    for name, resdiv in (("flange", 400), ("showerhead", 350), ("flange", 800),
                         ("bolt", 300), ("knurled", 350)):
        tree = trees[name]
        fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
        args = (tree, fr.origin, fr.res, fr.shape(), dev)
        row = {
            # plain, kernel, kernel, plain: the two versions in turns
            "classified_grid_plain": [cuda_ms(lambda: gk.classified_grid_plain(*args), 3)],
            "classified_grid": [cuda_ms(lambda: gk.classified_grid(*args), 10)],
            "grid_eval": [cuda_ms(lambda: gk.evaluate_grid(*args), 10)],
            "grid_eval_plain": [cuda_ms(lambda: gk.evaluate_grid_plain(*args), 3)],
        }
        row["classified_grid"].append(cuda_ms(lambda: gk.classified_grid(*args), 10))
        row["classified_grid_plain"].append(cuda_ms(lambda: gk.classified_grid_plain(*args), 3))
        row["grid_eval"].append(cuda_ms(lambda: gk.evaluate_grid(*args), 10))
        row["grid_eval_plain"].append(cuda_ms(lambda: gk.evaluate_grid_plain(*args), 3))
        times[f"{name}@{resdiv}"] = {k: min(v) for k, v in row.items()}
        log(f"  device ms {name}@{resdiv} grid {fr.shape()}: "
            + ", ".join(f"{k} {min(v):.3f}" for k, v in row.items()) + f"  [{card}]")

    # --- phases 3 and 4: the main path, counts from 0 around each part --
    launches = {k: 0 for k in gk.LAUNCHES}
    renders = (
        ("flange", 400, flagships.GOLDEN_FLANGE_TRIS),
        ("showerhead", 350, flagships.GOLDEN_SHOWERHEAD_TRIS),
        ("flange", 800, flagships.GOLDEN_FLANGE_800_TRIS),
        ("bolt", 300, flagships.GOLDEN_BOLT_TRIS),
        ("knurled", 350, flagships.GOLDEN_KNURLED_TRIS),
    )
    e2e = {}
    for name, resdiv, golden in renders:
        (ms, ntris, all_ms), counts = counted(
            gk, "classified_grid",
            lambda: cli.bench_part(trees[name], resdiv, golden, 5, dev),
        )
        for k, n in counts.items():
            launches[k] += n
        e2e[f"{name}@{resdiv}"] = ms
        log(f"phase 3: {name} resdiv {resdiv}: {ntris} triangles (golden {golden}), "
            f"SDF->STL warm median {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in all_ms)}) "
            f"launches {counts} [{card}]")
    for name, resdiv in (("flange", 400), ("bolt", 300), ("knurled", 350)):
        tree = trees[name]
        fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)

        def dense():
            field = gk.evaluate_grid(tree, fr.origin, fr.res, fr.shape(), dev)
            torch.cuda.synchronize()
            return field

        field, counts = counted(gk, "grid_eval", dense)
        for k, n in counts.items():
            launches[k] += n
        if not bool(torch.isfinite(field).all()):
            raise RuntimeError(f"evaluate_grid: non-finite distances on {name}")
        log(f"phase 3: evaluate_grid {name}@{resdiv} grid {tuple(field.shape)}: "
            f"launches {counts}")
    log(f"phase 4: kernel launches on the main path: {launches}")

    t400 = times["flange@400"]
    kernels = [
        {
            "name": "classified_grid",
            "route": "cuda",
            "source": "gsdf_tpu_torch/csrc/classified_grid.cu",
            "replaces": "gsdf_tpu/eval/pallas_grid.py:187",
            "launches": launches["classified_grid"],
            "max_abs_err": max_err["classified_grid"],
            "ms": t400["classified_grid"],
            "plain_ms": t400["classified_grid_plain"],
        },
        {
            "name": "grid_eval",
            "route": "cuda",
            "source": "gsdf_tpu_torch/csrc/grid_eval.cu",
            "replaces": "gsdf_tpu/eval/pallas_grid.py:108",
            "launches": launches["grid_eval"],
            "max_abs_err": max_err["grid_eval"],
            "ms": t400["grid_eval"],
            "plain_ms": t400["grid_eval_plain"],
        },
    ]
    log(json.dumps({"build_s": build_s, "device_ms": times, "sdf_to_stl_ms": e2e}))
    log(json.dumps({"kernels": kernels}))
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
