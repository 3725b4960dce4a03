"""Benchmark entry point of the port (the counterpart of gsdf_tpu/cli.py
bench_main).

`python -m gsdf_tpu_torch.cli [--device cuda]` renders the flange at
resdiv 400 and the showerhead at resdiv 350 through
FlatRenderer.render_compact + write_binary_stl_indexed and prints ONE JSON
line: the median warm SDF->STL wall ms of each (two warm-ups first), the
device it ran on, and the triangle counts, which must equal the golden
counts exactly or the run fails.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import time

import torch

from .flagships import (
    GOLDEN_FLANGE_TRIS,
    GOLDEN_SHOWERHEAD_TRIS,
    build_flange,
    build_showerhead,
)
from .render.flat import FlatRenderer
from .render.stl import write_binary_stl_indexed


def render_stl(obj, resdiv, device):
    """One SDF->STL render into memory: (wall ms, triangle count)."""
    res = obj.bounds().diagonal() / resdiv
    t0 = time.perf_counter()
    verts, tri_idx = FlatRenderer(obj, res, device).render_compact()
    buf = io.BytesIO()
    write_binary_stl_indexed(buf, verts, tri_idx)
    return (time.perf_counter() - t0) * 1e3, len(tri_idx)


def bench_part(obj, resdiv, golden, repeats, device):
    """Median warm SDF->STL wall ms after two warm-ups (the first builds
    the kernels), failing unless the triangle count equals `golden`
    (None skips the check). Returns (median ms, triangles, all ms)."""
    _, ntris = render_stl(obj, resdiv, device)
    render_stl(obj, resdiv, device)
    if golden is not None and ntris != golden:
        raise RuntimeError(f"triangle count {ntris} != golden {golden}")
    times = []
    for _ in range(repeats):
        ms, n = render_stl(obj, resdiv, device)
        if n != ntris:
            raise RuntimeError(f"triangle count changed between renders: {n} != {ntris}")
        times.append(ms)
    return statistics.median(times), ntris, times


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def bench_main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    flange_ms, flange_tris, _ = bench_part(
        build_flange(), 400, GOLDEN_FLANGE_TRIS, args.repeats, device
    )
    shower_ms, shower_tris, _ = bench_part(
        build_showerhead(), 350, GOLDEN_SHOWERHEAD_TRIS, args.repeats, device
    )
    print(
        json.dumps(
            {
                "metric": "npt-flange resdiv400 SDF->STL warm (median)",
                "value": flange_ms,
                "unit": "ms",
                "triangles": flange_tris,
                "device": device_name(device),
                "secondary": {
                    "metric": "fibonacci-showerhead resdiv350 SDF->STL warm (median)",
                    "value": shower_ms,
                    "unit": "ms",
                    "triangles": shower_tris,
                },
            }
        )
    )


if __name__ == "__main__":
    bench_main()
