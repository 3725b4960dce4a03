"""Benchmark entry points of the port (the counterparts of gsdf_tpu/cli.py
bench_main and breadth_main).

`python -m gsdf_tpu_torch.cli [--device cuda]` renders the flange at
resdiv 400 and the showerhead at resdiv 350 through
FlatRenderer.render_compact + write_binary_stl_indexed and prints ONE JSON
line: the median warm SDF->STL wall ms of each (two warm-ups first), each
one's `vs_baseline` (the reference implementation's ms over it), the
device it ran on, and the triangle counts, which must equal the golden
counts exactly or the run fails.

`python -m gsdf_tpu_torch.cli --breadth [--device cuda]` takes all four
golden parts (flange 400, showerhead 350, ISO M3 bolt 300, knurled
cylinder 350) through the same `bench_part` and prints one row per part.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import time

import torch

from .flagships import (
    GOLDEN_BOLT_TRIS,
    GOLDEN_FLANGE_TRIS,
    GOLDEN_KNURLED_TRIS,
    GOLDEN_SHOWERHEAD_TRIS,
    build_bolt,
    build_flange,
    build_knurled,
    build_showerhead,
)
from .render.flat import FlatRenderer
from .render.pruned import PrunedRenderer
from .render.stl import write_binary_stl, write_binary_stl_indexed

#: the reference implementation's end-to-end ms on an RX 6800 that the JAX
#: package's bench line divides by (gsdf_tpu/cli.py:77-92): the flange's
#: render + STL write, and the showerhead
BASELINE_FLANGE_MS = 706.0 + 371.0
BASELINE_SHOWERHEAD_MS = 701.0


def render_stl(obj, resdiv, device, path="compact", parametric=False):
    """One SDF->STL render into memory through `path`, "compact" (the main
    path), "soup" (render()), "indexed" (render_indexed()) or "pruned"
    (PrunedRenderer.render_compact()): (wall ms, triangle count).
    parametric=True renders the compact, indexed and pruned paths through
    the libraries of the part's structure."""
    res = obj.bounds().diagonal() / resdiv
    t0 = time.perf_counter()
    if path == "pruned":
        fr = PrunedRenderer(obj, res, device=device)
    else:
        fr = FlatRenderer(obj, res, device)
    buf = io.BytesIO()
    if path == "soup":
        if parametric:
            raise ValueError("render() has no parametric form")
        tris = fr.render()
        write_binary_stl(buf, tris)
        n = len(tris)
    elif path in ("compact", "indexed", "pruned"):
        render = fr.render_indexed if path == "indexed" else fr.render_compact
        verts, tri_idx = render(parametric=parametric)
        write_binary_stl_indexed(buf, verts, tri_idx)
        n = len(tri_idx)
    else:
        raise ValueError(f"unknown render path {path!r}")
    return (time.perf_counter() - t0) * 1e3, n


def bench_part(obj, resdiv, golden, repeats, device, path="compact", parametric=False):
    """Median warm SDF->STL wall ms after two warm-ups (the first builds
    the kernels), failing unless the triangle count equals `golden`
    (None skips the check). Returns (median ms, triangles, all ms)."""
    _, ntris = render_stl(obj, resdiv, device, path, parametric)
    render_stl(obj, resdiv, device, path, parametric)
    if golden is not None and ntris != golden:
        raise RuntimeError(f"triangle count {ntris} != golden {golden}")
    times = []
    for _ in range(repeats):
        ms, n = render_stl(obj, resdiv, device, path, parametric)
        if n != ntris:
            raise RuntimeError(f"triangle count changed between renders: {n} != {ntris}")
        times.append(ms)
    return statistics.median(times), ntris, times


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--breadth", action="store_true",
                    help="all four golden parts, one row each")
    ap.add_argument("--parametric", action="store_true",
                    help="render through the parametric kernel libraries")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    return args, device


def breadth_main(args, device):
    """Every golden part through the compact path, warm SDF->STL
    (in-memory), one row per part; all four counts are golden gates."""
    rows = [
        ("npt-flange", build_flange(), 400, GOLDEN_FLANGE_TRIS),
        ("fibonacci-showerhead", build_showerhead(), 350, GOLDEN_SHOWERHEAD_TRIS),
        ("iso-m3-bolt", build_bolt(), 300, GOLDEN_BOLT_TRIS),
        ("knurled-cylinder", build_knurled(), 350, GOLDEN_KNURLED_TRIS),
    ]
    for name, obj, resdiv, golden in rows:
        ms, n, _ = bench_part(obj, resdiv, golden, args.repeats, device,
                              parametric=args.parametric)
        print(f"{name} resdiv{resdiv}: {n:,} tris {ms:.2f} ms [{device_name(device)}]",
              flush=True)


def bench_main(argv=None):
    args, device = _args(argv)
    if args.breadth:
        return breadth_main(args, device)
    flange_ms, flange_tris, _ = bench_part(
        build_flange(), 400, GOLDEN_FLANGE_TRIS, args.repeats, device,
        parametric=args.parametric,
    )
    shower_ms, shower_tris, _ = bench_part(
        build_showerhead(), 350, GOLDEN_SHOWERHEAD_TRIS, args.repeats, device,
        parametric=args.parametric,
    )
    print(
        json.dumps(
            {
                "metric": "npt-flange resdiv400 SDF->STL warm (median)",
                "value": flange_ms,
                "unit": "ms",
                "vs_baseline": BASELINE_FLANGE_MS / flange_ms,
                "triangles": flange_tris,
                "device": device_name(device),
                "secondary": {
                    "metric": "fibonacci-showerhead resdiv350 SDF->STL warm (median)",
                    "value": shower_ms,
                    "unit": "ms",
                    "vs_baseline": BASELINE_SHOWERHEAD_MS / shower_ms,
                    "triangles": shower_tris,
                },
            }
        )
    )


if __name__ == "__main__":
    bench_main()
