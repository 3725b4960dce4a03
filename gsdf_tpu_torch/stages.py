"""Stage breakdown of the FlatRenderer's three paths on a CUDA card.

    python -m gsdf_tpu_torch.stages [--runs 7] [--out stages.json]

For each path and part (compact on the five golden grids; soup and
indexed on flange 400, showerhead 350 and flange 800) it runs the path's
stages by hand, as FlatRenderer runs them, with a synchronise after each
so the host clock splits one SDF->STL render into K1, K3, K4 / K7s / K7w,
fetch, host decode or weld, and STL encode. It prints the median of each
stage over the runs after the first two, and the device time that
torch.profiler sums over one more render, with the idle share 1 - device
time / wall time. Triangle counts must equal the golden counts.

    python -m gsdf_tpu_torch.stages --parametric

runs the compact and indexed rows through K1's parametric form (the
kernel library of the part's structure, eval/parametric.py).

    python -m gsdf_tpu_torch.stages --wrappers

instead splits one call of each marching-cubes wrapper (K3, K3 with the
edge ranks, K4, K7s, K7w) on the five golden grids into the host's time
to make the call (host clock over 200 calls, nothing awaited) and the
device time of each kernel, memset and copy in it (torch.profiler, mean
of 30 calls): a wrapper timed back to back shows the larger of the two.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from . import flagships, native
from .eval.grid_kernels import classified_grid
from .ops import compact_field, fused_welded, mc_emit
from .render.flat import FlatRenderer
from .render.stl import stl_header

PARTS = {
    ("flange", 400): flagships.GOLDEN_FLANGE_TRIS,
    ("showerhead", 350): flagships.GOLDEN_SHOWERHEAD_TRIS,
    ("flange", 800): flagships.GOLDEN_FLANGE_800_TRIS,
    ("bolt", 300): flagships.GOLDEN_BOLT_TRIS,
    ("knurled", 350): flagships.GOLDEN_KNURLED_TRIS,
}


class Clock:
    """Host ms per stage; each lap synchronises the card first."""

    def __init__(self):
        self.ms = {}
        self.t = time.perf_counter()

    def lap(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now


def _encode(c, verts=None, tri=None, soup=None):
    buf = io.BytesIO()
    if soup is not None:
        buf.write(stl_header(len(soup)))
        buf.write(native.stl_encode(soup))
    else:
        buf.write(stl_header(len(tri)))
        buf.write(native.stl_encode_indexed(verts, tri))
    c.lap("STL encode")


def compact(fr, c, parametric=False):
    dist, cases = classified_grid(fr.s, fr.origin, fr.res, fr.shape(), fr.device, 0, parametric)
    c.lap("K1")
    comp = mc_emit.compact_active(cases)
    ids = comp.ids
    c.lap("K3")
    idx8, t = compact_field.compact_emit(dist, cases, ids, comp.n_t, comp.offsets)
    c.lap("K4")
    payload = ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(), t.cpu().numpy()
    c.lap("fetch")
    verts, tri = native.mc_decode(*payload, fr.nx, fr.ny, fr.nz, fr.origin, fr.res)
    c.lap("host decode")
    _encode(c, verts, tri)
    return len(tri), sum(a.nbytes for a in payload)


def _soup(fr, c):
    parts = []
    for k0, shape in fr.soup_slabs():
        dist, cases = classified_grid(fr.s, fr.origin, fr.res, shape, fr.device, k0)
        c.lap("K1")
        comp = mc_emit.compact_active(cases)
        c.lap("K3")
        tris = mc_emit.emit_triangles(dist, cases, comp.ids, fr.origin, fr.res, k0,
                                      comp.n_tris, comp.tri_offsets)
        c.lap("K7s")
        parts.append(tris.cpu().numpy())
        c.lap("fetch")
    if len(parts) == 1:
        return parts[0]
    soup = np.concatenate(parts)
    c.lap("concat")
    return soup


def soup(fr, c, parametric=False):
    tris = _soup(fr, c)
    _encode(c, soup=tris)
    return len(tris), tris.nbytes


def indexed(fr, c, parametric=False):
    nk, nj, ni = fr.shape()
    if nk * nj * ni > fr.slab_cubes:  # FlatRenderer.render_indexed's gate
        tris = _soup(fr, c)
        verts, tri = native.weld(tris, 0.0)
        c.lap("host weld")
        nbytes = tris.nbytes
    else:
        dist, cases = classified_grid(fr.s, fr.origin, fr.res, fr.shape(), fr.device, 0,
                                      parametric)
        c.lap("K1")
        comp = mc_emit.compact_active(cases, edge_ranks=True)
        c.lap("K3")
        buf, n_verts, n_tris = fused_welded.welded_buffer(dist, cases, comp.ids, fr.origin,
                                                          fr.res, 0, comp)
        c.lap("K7w")
        verts, tri, unresolved = (a.numpy() for a in
                                  fused_welded.split_welded(buf.cpu(), n_verts, n_tris))
        c.lap("fetch")
        if unresolved:
            raise RuntimeError("unresolved owner cubes on a golden part")
        nbytes = verts.nbytes + tri.nbytes
    _encode(c, verts, tri)
    return len(tri), nbytes


def device_busy_ms(fn):
    """(device ms summed by torch.profiler, wall ms) of one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy, wall


def host_us(fn, n=200):
    """Host microseconds to make one call of fn, nothing awaited."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, n=30):
    """Device microseconds per call of fn, by kernel, memset and copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].strip():
            round(e.device_time_total / n, 2)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def wrappers(trees, dev, card):
    """Host and device time of one call of each marching-cubes wrapper."""
    out = {"card": card}
    for name, resdiv in PARTS:
        fr = FlatRenderer(trees[name], trees[name].bounds().diagonal() / resdiv, dev)
        dist, cases = classified_grid(fr.s, fr.origin, fr.res, fr.shape(), dev)
        comp = mc_emit.compact_active(cases, edge_ranks=True)
        o, r = fr.origin, fr.res
        calls = {
            "K3": lambda: mc_emit.compact_active(cases),
            "K3 with edge ranks": lambda: mc_emit.compact_active(cases, edge_ranks=True),
            "K4": lambda: compact_field.compact_emit(dist, cases, comp.ids, comp.n_t, comp.offsets),
            "K7s": lambda: mc_emit.emit_triangles(dist, cases, comp.ids, o, r, 0, comp.n_tris,
                                                  comp.tri_offsets),
            "K7w": lambda: fused_welded.emit_welded(dist, cases, comp.ids, o, r, 0, comp=comp),
        }
        for k, fn in calls.items():
            row = {"host_us": round(host_us(fn), 1), "device_us": device_us(fn)}
            out[f"{k} {name}@{resdiv}"] = row
            print(f"{k} {name}@{resdiv}: host {row['host_us']} us a call, device us "
                  f"{row['device_us']} [{card}]", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=7, help="renders per row; the first two warm up")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--parametric", action="store_true",
                    help="the compact and indexed rows through K1's parametric form")
    ap.add_argument("--wrappers", action="store_true",
                    help="split each marching-cubes wrapper's call into host and device time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stages: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    trees = {n: getattr(flagships, f"build_{n}")() for n in ("flange", "showerhead", "bolt",
                                                               "knurled")}
    if args.wrappers:
        out = wrappers(trees, dev, card)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return
    rows = [("compact", compact, part) for part in PARTS]
    rows += [(p, f, part) for p, f in (("soup", soup), ("indexed", indexed))
             for part in list(PARTS)[:3]]
    if args.parametric:  # K1p's rows: the soup, and flange 800's weld of it, have none
        rows = [r for r in rows if r[0] != "soup" and not (r[0] == "indexed" and r[2][1] == 800)]
    out = {"card": card}
    for path, fn, (name, resdiv) in rows:
        tree = trees[name]

        def render(c):
            fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
            return fn(fr, c, args.parametric)

        runs = []
        for _ in range(args.runs):
            c = Clock()
            ntris, nbytes = render(c)
            if ntris != PARTS[(name, resdiv)]:
                raise RuntimeError(f"{path} {name}@{resdiv}: {ntris} triangles, "
                                   f"golden {PARTS[(name, resdiv)]}")
            runs.append(c.ms)
        keep = runs[2:] or runs
        stages = {k: statistics.median(r[k] for r in keep) for k in keep[0]}
        total = statistics.median(sum(r.values()) for r in keep)
        busy, wall = device_busy_ms(lambda: render(Clock()))
        kernel_ms = sum(v for k, v in stages.items() if k.startswith("K"))
        out[f"{path} {name}@{resdiv}"] = {
            "stages_ms": stages, "total_ms": total, "tris": ntris, "fetch_mb": nbytes / 1e6,
            "kernel_stage_share": kernel_ms / total, "device_ms": busy,
            "profiled_wall_ms": wall, "idle_share": 1 - busy / wall,
        }
        print(f"{path} {name}@{resdiv}: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; total {total:.3f} ms, kernel stages {kernel_ms / total:.3f} of it, "
              f"{ntris} tris, fetch {nbytes / 1e6:.2f} MB, device {busy:.3f} ms, "
              f"idle {1 - busy / wall:.3f} [{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
