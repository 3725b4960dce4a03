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

    python -m gsdf_tpu_torch.stages --dc

runs dual contouring instead: the bolt at resdiv 256, 384 and 512 (the
last on the chunk route) through DualContourRenderer's stages by hand,
K5 (with its one count read), fetch, host quad emission, STL encode; past
mono_voxels a K5 and a fetch per chunk.

    python -m gsdf_tpu_torch.stages --pruned

runs the pruned renderer instead: PrunedRenderer.render_compact by hand
on flange 400, showerhead 350, bolt 300, flange 800 and flange 1000 (and
the dense compact row of flange 1000 beside it): the coarse pass (K6c,
the mask's fetch and the host's tile list), then per batch of tiles K6a,
K3 (with its count read), the id map, K4 and the fetch (each summed over
the batches), the host merge of the batches, decode and STL encode.

    git show 506a570:gsdf_tpu_torch/csrc/emit_soup.cu > .scratch/emit_soup_506a570.cu
    python -m gsdf_tpu_torch.stages --k7s-turns .scratch/emit_soup_506a570.cu

times K7s's dense mode as that earlier source builds it (before the tile
mode, commit 506a570) against this checkout's, in turns, after holding
their soups equal, on K1's grid of each golden grid.

    python -m gsdf_tpu_torch.stages --wrappers

instead splits one call of each marching-cubes wrapper (K3, K3 with the
edge ranks, K4, K7s, K7w) on the five golden grids into the host's time
to make the call (host clock over 200 calls, nothing awaited) and the
device time of each kernel, memset and copy in it (torch.profiler, mean
of 30 calls): a wrapper timed back to back shows the larger of the two.
"""
from __future__ import annotations

import argparse
import ctypes
import io
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from . import flagships, native
from .eval import grid_kernels
from .eval.grid_kernels import classified_grid
from .ops import compact_field, fused_welded, mc_emit
from .render import dual_contour
from .render.flat import FlatRenderer
from .render.pruned import PrunedRenderer
from .render.stl import stl_header

PARTS = {
    ("flange", 400): flagships.GOLDEN_FLANGE_TRIS,
    ("showerhead", 350): flagships.GOLDEN_SHOWERHEAD_TRIS,
    ("flange", 800): flagships.GOLDEN_FLANGE_800_TRIS,
    ("bolt", 300): flagships.GOLDEN_BOLT_TRIS,
    ("knurled", 350): flagships.GOLDEN_KNURLED_TRIS,
}


#: the pruned rows: the compact goldens the pruned payload reaches exactly
#: (the flange, showerhead and bolt are 1-Lipschitz enough; ROADMAP.md) and
#: flange 1000, the size the JAX package's examples/prune_scale.py measures
PRUNED_PARTS = {
    ("flange", 400): flagships.GOLDEN_FLANGE_TRIS,
    ("showerhead", 350): flagships.GOLDEN_SHOWERHEAD_TRIS,
    ("bolt", 300): flagships.GOLDEN_BOLT_TRIS,
    ("flange", 800): flagships.GOLDEN_FLANGE_800_TRIS,
    ("flange", 1000): flagships.GOLDEN_FLANGE_1000_TRIS,
}

#: the dual contouring rows: the bolt's goldens (tests/test_dual_contour.py:191,
#: tests/test_golden_scale.py:30-31); resdiv 512 is past mono_voxels
DC_PARTS = {("bolt", 256): 99_844, ("bolt", 384): 226_340, ("bolt", 512): 403_104}


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


def pruned(pr, c, parametric=False):
    """One PrunedRenderer.render_compact by hand, its stages as the
    renderer runs them: coarse (K6c, the mask's fetch, the tile list),
    then per batch K6a, K3, the id map, K4 and the fetch, then the host
    merge, decode and STL encode."""
    tiles = pr._prune(parametric)
    c.lap("K6c + mask fetch")
    parts = []
    for batch in pr._batches(tiles):
        dist, cases = grid_kernels.tile_grid(pr.s, batch, pr.origin, pr.res, pr.S, pr.dims(),
                                             pr.device, parametric)
        c.lap("K6a")
        comp = mc_emit.compact_active(cases)
        c.lap("K3")
        ids = compact_field.tile_global_ids(comp.ids, batch, pr.S, pr.dims())
        c.lap("K id map")
        idx8, t = compact_field.compact_emit(dist, cases, comp.ids, comp.n_t, comp.offsets)
        c.lap("K4")
        parts.append((ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(), t.cpu().numpy()))
        c.lap("fetch")
    payload = compact_field.merge_compact_payloads(parts)
    c.lap("merge")
    verts, tri = native.mc_decode(*payload, pr.nx, pr.ny, pr.nz, pr.origin, pr.res)
    c.lap("host decode")
    _encode(c, verts, tri)
    return len(tri), sum(a.nbytes for p in parts for a in p)


def dc(dcr, c, parametric=False):
    """One DualContourRenderer render by hand: K5 (its count read
    included) and the fetch, per chunk past mono_voxels, then the host
    quad emission and the STL encode."""
    chunks, space = dcr.chunks()
    tris, _, _, nbytes = dual_contour.mesh_chunks(dcr.s, dcr.res, dcr.contourer, dcr.device,
                                                  parametric, chunks, space, c.lap)
    _encode(c, soup=tris)
    return len(tris), nbytes


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


#: gsdf_emit_soup's C signature before K7s took a tile table (the dense
#: mode alone): no `tiles` argument between k0 and tri_offsets
_K7S_DENSE_ONLY = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 3


def k7s_turns(trees, dev, card, source, launches=200, rounds=3):
    """K7s's dense mode built from another version of csrc/emit_soup.cu
    (`source`, one from before the tile mode) against this checkout's, on
    K1's grid and K3's result of each golden grid: both entry points
    called raw through ctypes on the same inputs, the outputs equal, then
    `rounds` rounds of other, this, this, other, each `launches` launches
    back to back between CUDA events. Returns {grid: row}."""
    from . import _build, kernels

    with open(source) as f:
        text = f.read()
    header = kernels.tables_header()
    key = _build.source_key(text, header, *kernels.NVCC_FLAGS)

    def command(out, d):
        _build.write_atomic(os.path.join(d, kernels.TABLES_HEADER), header)
        _build.write_atomic(os.path.join(d, "emit_soup_other.cu"), text)
        return [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-I", kernels.CSRC, "-o", out,
                os.path.join(d, "emit_soup_other.cu")]

    other = _build.load(_build.build_shared("gsdf_emit_soup_other", key, command),
                        {"gsdf_emit_soup": (ctypes.c_int, _K7S_DENSE_ONLY)})
    this = kernels.static_lib("emit_soup")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"card": card, "source": source}
    for name, resdiv in PARTS:
        fr = FlatRenderer(trees[name], trees[name].bounds().diagonal() / resdiv, dev)
        dist, cases = classified_grid(fr.s, fr.origin, fr.res, fr.shape(), dev)
        comp = mc_emit.compact_active(cases)
        head = (dist.data_ptr(), cases.data_ptr(), comp.ids.data_ptr(), len(comp.ids), fr.nx,
                fr.ny, *kernels.float_args(fr.origin, fr.res, 0))
        t_other = torch.empty((comp.n_tris, 3, 3), dtype=torch.float32, device=dev)
        t_this = torch.empty_like(t_other)

        def run_other():
            if other.gsdf_emit_soup(*head, comp.tri_offsets.data_ptr(), t_other.data_ptr(),
                                    stream):
                raise RuntimeError("the other K7s did not launch")

        def run_this():
            if this.gsdf_emit_soup(*head, None, comp.tri_offsets.data_ptr(), t_this.data_ptr(),
                                   stream):
                raise RuntimeError("K7s did not launch")

        run_other()
        run_this()
        torch.cuda.synchronize()
        if not torch.equal(t_other, t_this):
            raise RuntimeError(f"K7s {name}@{resdiv}: the two versions' soups differ")

        def ms(fn):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / launches

        o, n = [], []
        for _ in range(rounds):
            o.append(ms(run_other))
            n += [ms(run_this), ms(run_this)]
            o.append(ms(run_other))
        row = {"other_ms": o, "this_ms": n, "other_min": min(o), "this_min": min(n),
               "other_median": statistics.median(o), "this_median": statistics.median(n),
               "tris": comp.n_tris}
        out[f"{name}@{resdiv}"] = row
        print(f"K7s dense {name}@{resdiv}: equal soups ({comp.n_tris} triangles); other "
              f"version min {row['other_min']:.4f} ms, this checkout's {row['this_min']:.4f} "
              f"ms; medians {row['other_median']:.4f} / {row['this_median']:.4f} ms ({launches} "
              f"launches back to back, {rounds} rounds of other, this, this, other) [{card}]",
              flush=True)
        del dist, cases, comp, t_other, t_this
    return out


def measure(render, golden, runs):
    """One row: render(Clock()) `runs` times, each holding the golden
    count; the median of each stage over the runs after the first two, and
    the device ms torch.profiler sums over one more render (the most of
    three such renders)."""
    laps = []
    for _ in range(runs):
        c = Clock()
        ntris, nbytes = render(c)
        if ntris != golden:
            raise RuntimeError(f"{ntris} triangles, golden {golden}")
        laps.append(c.ms)
    keep = laps[2:] or laps
    stages = {k: statistics.median(r[k] for r in keep) for k in keep[0]}
    total = statistics.median(sum(r.values()) for r in keep)
    # a trace can miss device events, never add any: the most of three
    busy, wall = max(device_busy_ms(lambda: render(Clock())) for _ in range(3))
    kernel_ms = sum(v for k, v in stages.items() if k.startswith("K"))
    return {"stages_ms": stages, "total_ms": total, "tris": ntris, "fetch_mb": nbytes / 1e6,
            "kernel_stage_share": kernel_ms / total, "device_ms": busy,
            "profiled_wall_ms": wall, "idle_share": 1 - busy / wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=7, help="renders per row; the first two warm up")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--parametric", action="store_true",
                    help="the compact and indexed rows through K1's parametric form")
    ap.add_argument("--dc", action="store_true",
                    help="dual contouring rows (the bolt at resdiv 256, 384, 512) instead")
    ap.add_argument("--pruned", action="store_true",
                    help="pruned renderer rows (flange 400 to 1000, showerhead, bolt) instead")
    ap.add_argument("--wrappers", action="store_true",
                    help="split each marching-cubes wrapper's call into host and device time")
    ap.add_argument("--k7s-turns", metavar="EMIT_SOUP_CU",
                    help="time K7s's dense mode against this earlier emit_soup.cu, in turns")
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
    if args.wrappers or args.k7s_turns:
        out = (k7s_turns(trees, dev, card, args.k7s_turns) if args.k7s_turns
               else wrappers(trees, dev, card))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return
    rows = [("compact", compact, part) for part in PARTS]
    rows += [(p, f, part) for p, f in (("soup", soup), ("indexed", indexed))
             for part in list(PARTS)[:3]]
    if args.parametric:  # K1p's rows: the soup, and flange 800's weld of it, have none
        rows = [r for r in rows if r[0] != "soup" and not (r[0] == "indexed" and r[2][1] == 800)]
    if args.dc:
        rows = [("dc", None, part) for part in DC_PARTS]
    if args.pruned:
        rows = [("pruned", None, part) for part in PRUNED_PARTS]
        rows.append(("compact", compact, ("flange", 1000)))
    out = {"card": card}
    for path, fn, (name, resdiv) in rows:
        tree = trees[name]
        res = tree.bounds().diagonal() / resdiv
        if path == "dc":
            def render(c):
                return dc(dual_contour.DualContourRenderer(tree, res, device=dev), c,
                          args.parametric)
            golden = DC_PARTS[(name, resdiv)]
        elif path == "pruned":
            def render(c):
                return pruned(PrunedRenderer(tree, res, device=dev), c, args.parametric)
            golden = PRUNED_PARTS[(name, resdiv)]
        else:
            def render(c, fn=fn):
                return fn(FlatRenderer(tree, res, dev), c, args.parametric)
            golden = {**PARTS, **PRUNED_PARTS}[(name, resdiv)]
        out[f"{path} {name}@{resdiv}"] = row = measure(render, golden, args.runs)
        print(f"{path} {name}@{resdiv}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in row["stages_ms"].items())
              + f"; total {row['total_ms']:.3f} ms, kernel stages "
              f"{row['kernel_stage_share']:.3f} of it, {row['tris']} tris, fetch "
              f"{row['fetch_mb']:.2f} MB, device {row['device_ms']:.3f} ms, idle "
              f"{row['idle_share']:.3f} [{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
