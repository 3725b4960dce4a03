#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name, power limit), torch and CUDA
   versions; fails without a CUDA device.
2. Builds the CUDA kernels of three trees from the checkout's sources
   (nvcc, sm_90a) and holds K2 (grid eval) and K1 (fused eval + classify)
   against their plain torch versions on the card, on a small tree of all
   nine node types and at every main-path grid shape: case grids exactly
   equal, distances within 1e-5 * max(1, |d|). Times each kernel against
   its plain version with CUDA events.
3. Drives the main path with every launch count at 0: FlatRenderer
   .render_compact + write_binary_stl_indexed on flange resdiv 400,
   showerhead resdiv 350 and flange resdiv 800 (golden triangle counts,
   exact; median warm ms after two warm-ups), plus evaluate_grid on the
   flange-400 grid, the dense-field entry point.
4. Fails unless both kernels launched during phase 3.

The line before the last is nvidia-smi's card name and power limit; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

TOL = 1e-5  # relative to max(1, |d|): atan2f (CUDA) vs torch.atan2's ulp


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
    """Small tree with all nine node types of the ported slice."""
    import numpy as np

    hole = b.new_cylinder(0.2, 3.0)
    holes = [b.translate(hole, np.cos(a), np.sin(a), 0) for a in np.linspace(0, 6, 7)]
    ring = b.union(b.new_cylinder(1.5, 0.5), *holes)
    cut = b.scale(b.difference(b.new_cylinder(1.0, 2.0), b.new_cylinder(0.5, 3.0)), 0.8)
    body = b.intersection(b.smooth_union(0.2, ring, cut), b.new_cylinder(1.8, 1.8, 0.1))
    return b.union(body, threads.screw(b, 2.0, threads.ISO(d=2.0, p=0.4, ext=True)))


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
            f"  {kname:15s} {name:12s} grid {shape}: max|d-plain| {out[kname]:.3e} "
            f"(rel {rel:.3e}), differing floats {int((diff > 0).sum())} of {d.numel()}"
        )
        if rel > TOL:
            raise RuntimeError(f"{kname} {name}: distances off by {rel:.3e} > {TOL}")
    n_case_diff = int((c1 != pc).sum())
    log(
        f"  classified_grid {name:12s} cases: {n_case_diff} differing of {c1.numel()}, "
        f"{int((c1 != 0).sum())} active"
    )
    if n_case_diff:
        raise RuntimeError(f"classified_grid {name}: case grid differs from plain")
    if not torch.equal(d1, d2):
        raise RuntimeError(f"{name}: K1 and K2 distances differ")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from gsdf_tpu_torch import Builder, cli, flagships
        from gsdf_tpu_torch.eval import grid_kernels as gk
        from gsdf_tpu_torch.forge import threads
        from gsdf_tpu_torch.render.flat import FlatRenderer
    except ImportError as e:
        print(f"chip_smoke: gsdf_tpu_torch not importable ({e}); run it in the "
              "repository root", file=sys.stderr)
        return 3

    # --- phase 1: the card -------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # --- phase 2: build, compare, time ---------------------------------
    trees = {
        "nine-types": nine_type_tree(Builder(), threads),
        "flange": flagships.build_flange(),
        "showerhead": flagships.build_showerhead(),
    }
    build_s = {}
    for name, tree in trees.items():
        t0 = time.perf_counter()
        gk.build(tree)
        build_s[name] = time.perf_counter() - t0
        log(f"phase 2: built {name} kernels in {build_s[name]:.1f} s")
        for line in gk.build_log(tree).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain torch on the card")
    max_err = {"grid_eval": 0.0, "classified_grid": 0.0}
    for name, resdiv in (
        ("nine-types", 60), ("flange", 100), ("flange", 400),
        ("showerhead", 350), ("flange", 800),
    ):
        errs = compare(f"{name}@{resdiv}", trees[name], resdiv, dev, gk)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)

    times = {}
    for name, resdiv in (("flange", 400), ("showerhead", 350), ("flange", 800)):
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

    # --- phase 3: the main path, launch counts from 0 -------------------
    gk.reset_launches()
    renders = (
        ("flange", 400, flagships.GOLDEN_FLANGE_TRIS),
        ("showerhead", 350, flagships.GOLDEN_SHOWERHEAD_TRIS),
        ("flange", 800, flagships.GOLDEN_FLANGE_800_TRIS),
    )
    for name, resdiv, golden in renders:
        ms, ntris, all_ms = cli.bench_part(trees[name], resdiv, golden, 5, dev)
        log(f"phase 3: {name} resdiv {resdiv}: {ntris} triangles (golden {golden}), "
            f"SDF->STL warm median {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in all_ms)}) "
            f"[{card}]")
    flange = trees["flange"]
    fr = FlatRenderer(flange, flange.bounds().diagonal() / 400, dev)
    field = gk.evaluate_grid(flange, fr.origin, fr.res, fr.shape(), dev)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(field).all()):
        raise RuntimeError("evaluate_grid: non-finite distances on the flange")
    launches = dict(gk.LAUNCHES)
    log(f"phase 3: kernel launches on the main path: {launches}")

    # --- phase 4: every kernel of the path ran -------------------------
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")

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
    log(json.dumps({"build_s": build_s, "device_ms": times}))
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
