"""CPU tests of the benchmark (no card): its arithmetic, its generator, its
reference, and that its check fails what it should fail.

    python -m pytest torch_bench/tests -q
"""
from __future__ import annotations

import ast
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import shutil

import numpy as np
import pytest
import torch

from torch_bench import bounds, control, generator, harness, kinds, spec, stats
from torch_bench import trace as tr
from torch_bench.reference import mc

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
#: every cell with limits: the benchmark's cells and those kept ready for
#: later (`<config>.<mix>`), one of each request kind
CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "limits")) if f.endswith(".json"))
#: the readers each kind's sound run has a number for (tracing off)
READS = {"export": ["setup_s", "export_ms", "render_ms.export", "stl_ms.export"],
         "edit": ["setup_s", "edit_ms", "edit_p95_ms", "rebind_ms.edit"],
         "view": ["setup_s", "frame_p95_ms"]}
#: small sizes a CPU run can hold: the parts at resdiv 40, frames of 24 x 20
SMALL = {"resdiv": 40}
SMALL_FRAME = {"width": 24, "height": 20, "aa": 2, "steps": 48}


def cell_of(name):
    """The cell `name` (`<config>.<mix>`), in BENCHMARK.json or not."""
    config, mix = name.split(".", 1)
    return spec.make(name, config, mix)


def small(name):
    c = cell_of(name)
    mix = dict(c.mix)
    if "frame" in mix:
        mix["frame"] = {**mix["frame"], **SMALL_FRAME}
    return c._replace(config={**c.config, **SMALL}, mix=mix)


def config_cell(config):
    """A cell of the configuration `config`."""
    return cell_of(next(c for c in CELLS if c.split(".")[0] == config))


def program_part(cell):
    return kinds.program_attr(cell.config["builder"])()


# --- arithmetic ------------------------------------------------------------
def test_percentile_and_window_rate_on_known_lists():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50.5
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([4, 1, 3, 2], 0) == 1 and stats.percentile([4, 1, 3, 2], 100) == 4
    for q in (5, 50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert stats.per_request_ms(15.0, 300) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.per_request_ms(1.0, 0)
    q1, _, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / 3.5)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_kernel_bytes_rules_on_one_known_grid():
    # flange 400: 281 x 281 x 85 corners, 280 x 280 x 84 cubes; 1,000 active
    # cubes with 1,500 crossing edges
    corners, cubes = 281 * 281 * 85, 280 * 280 * 84
    assert bounds.kernel_bytes("classified_grid", corners=corners, cubes=cubes) == \
        4 * 6_711_685 + 6_585_600
    assert bounds.kernel_bytes("classified_grid", corners=corners, cubes=cubes, n_params=14) == \
        4 * 6_711_685 + 6_585_600 + 56
    # offsets: 8 B per started block of 256 active cubes (4 blocks)
    assert bounds.kernel_bytes("compact_active", cubes=cubes, active=1000) == \
        6_585_600 + 4000 + 2 * 32 + 24
    assert bounds.kernel_bytes("compact_emit", active=1000, n_t=1500) == 22_000 + 32 + 6000
    assert bounds.kernel_bytes("raymarch", pixels=512 * 512) == 786_432
    # a compact render is bound by the tree's operations on this grid
    s = bounds.mesh_bound_s(corners, cubes, 1000, 1500, 336)
    assert s == pytest.approx(corners * 336 / bounds.FP32_PEAK
                              + (6_585_600 + 4000 + 88) / bounds.HBM_PEAK
                              + (22_032 + 6000) / bounds.HBM_PEAK)


@pytest.mark.parametrize("name", ["flange400", "showerhead350"])
def test_op_counter_reproduces_the_frozen_ops_per_point(name):
    cell = config_cell(name)
    ref = cell.reference.part()
    frozen = cell.config["ops_per_point"]
    assert bounds.ops_per_point(ref, ref.bounds()) == frozen
    prog = program_part(cell)
    bb = prog.bounds()
    assert bounds.ops_per_point(prog, (bb.min, bb.max)) == frozen


def test_view_arithmetic_is_counted():
    from torch_bench.kinds.view import view_arithmetic

    step, ray = view_arithmetic()
    assert step > 0 and ray > step
    assert bounds.raymarch_ops(100, 10, 5, step, ray) == 500 + 50 * step + 10 * ray


def _site(name, skips, lanes=None, member=False):
    return {("member" if member else "subtrahend"): name, "bound": "point" if member else -1.0,
            "lanes": lanes if lanes is not None else skips, "lane_skips": skips, "turns": 0,
            "turn_skips": 0}


def _loop(name, members, entries, walked):
    return {"loop": name, "members": members, "entries": entries, "walked": walked,
            "turns": 0, "turn_walked": 0}


def test_work_run_takes_off_what_the_lanes_skipped():
    counts = {"diff": _site("holes", 80, 100), "u/cyl": _site("cyl", 30, 100, member=True),
              "holes/cyl*130": _loop("hole", 130, 20, 25)}
    fn_ops = {"holes": 2617, "cyl": 18, "hole": 16}
    skipped = 80 * 2617 + 30 * 18 + (20 * 130 - 25) * 16
    assert bounds.skipped_ops(counts, fn_ops) == skipped
    assert bounds.work_run(100 * 3367, counts, fn_ops) == 100 * 3367 - skipped
    assert [bounds.skipped_function(c) for c in counts.values()] == ["holes", "cyl", "hole"]
    # no count, nothing skipped: the counted work is the work run
    assert bounds.work_run(12345, {}, {}) == 12345


def test_skipped_work_never_exceeds_the_counted():
    fn_ops = {"holes": 2617, "hole": 16}
    with pytest.raises(ValueError):  # more skipped than ten evaluations counted
        bounds.work_run(10 * 3367, {"d": _site("holes", 20, 20)}, fn_ops)
    with pytest.raises(ValueError):  # a loop that walked more members than it has
        bounds.work_run(10**6, {"l": _loop("hole", 130, 2, 300)}, fn_ops)
    assert bounds.work_run(10 * 2617, {"d": _site("holes", 10)}, fn_ops) == 0


def _view_kind(part):
    from torch_bench.kinds.view import Kind

    return Kind(small("showerhead350.view"), part, "cpu")


def _frame_ops(part, kind, views):
    """raymarch_ops of K8's plain evaluations at `views`, at the cell's
    frozen ops a point."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.visual import raymarch as vr
    from torch_bench.kinds.view import view_arithmetic

    step, ray = view_arithmetic()
    rays = kind.w * kind.h * kind.aa ** 2
    total = 0
    for yaw, pitch in views:
        cam = vr.camera(part, yaw, pitch, kind.cam_dist)
        _, ev = rk.raymarch_plain(part, cam, kind.w, kind.h, kind.steps, vr.auto_relax(part),
                                  kind.aa, "cpu", evals=True)
        total += bounds.raymarch_ops(int(ev.sum()), rays, kind.config["ops_per_point"], step,
                                     ray)
    return total


def test_a_site_free_tree_counts_every_evaluation_in_full(capsys):
    from gsdf_tpu_torch import Builder
    from gsdf_tpu_torch.eval import ray_kernels as rk

    b = Builder()
    part = b.intersection(b.new_box(1.0, 0.8, 0.6), b.new_sphere(0.6))
    assert not rk.sites(part) and not rk.loops(part)
    kind = _view_kind(part)
    views = [(0.6, 0.5), (2.0, -0.3)]
    kind.frames[:] = views
    kind.count_work((0, 0))
    ops = _frame_ops(part, kind, views)
    assert kind.bound_s(2) == bounds.bound_s(ops, 2 * kind.w * kind.h * 3)
    assert f"{ops} ops counted, {ops} ops run, skipped share 0.0" in capsys.readouterr().err


def test_count_work_reads_the_counting_forms_skips(monkeypatch, capsys):
    """The showerhead's sites and loop, counted by a stand-in for K8's
    counting form (the plain frame, and known skips)."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from torch_bench.kinds.view import function_ops

    cell = config_cell("showerhead350")
    part = program_part(cell)
    sites, loops = rk.sites(part), rk.loops(part)
    assert sites and loops

    def counting_form(tree, cam, w, h, steps, relax, aa, device):
        img, ev = rk.raymarch(tree, cam, w, h, steps, relax, aa, device, evals=True)
        n = int(ev.sum())
        for site, sub, lo in sites:
            c = rk.SHORT_CIRCUITS.setdefault(site, _site(sub, 0, 0, member=lo is None))
            c["lanes"] += n
            c["lane_skips"] += n // 4
        for loop, member, m in loops:
            c = rk.SHORT_CIRCUITS.setdefault(loop, _loop(member, m, 0, 0))
            c["entries"] += n // 8
            c["walked"] += n // 8
        return img, ev

    monkeypatch.setattr(rk, "count_short_circuits", counting_form)
    kind = _view_kind(part)
    views = [(0.6, 0.5), (4.0, 0.9)]
    kind.frames[:] = [(0.0, 0.0)] + views  # the first is before the mark
    rk.SHORT_CIRCUITS["stale"] = _site("nothing", 10**12)  # cleared before the frames
    kind.count_work((0, 1))
    counted = _frame_ops(part, kind, views)
    fn_ops = function_ops(part, [s[1] for s in sites] + [lp[1] for lp in loops])
    skipped = bounds.skipped_ops(rk.SHORT_CIRCUITS, fn_ops)
    assert 0 < skipped < counted and "stale" not in rk.SHORT_CIRCUITS
    assert kind.bound_s(2) == bounds.bound_s(counted - skipped, 2 * kind.w * kind.h * 3)
    err = capsys.readouterr().err
    assert "work of 2 frames: " in err and f"{counted - skipped} ops run" in err
    rk.SHORT_CIRCUITS.clear()


def test_function_ops_are_chip_smokes_site_ops():
    """The benchmark's ops a point of each skipped function, by name, are
    those chip_smoke counts on the program's plain nodes."""
    import chip_smoke
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from torch_bench.kinds.view import function_ops

    part = program_part(config_cell("showerhead350"))
    named = {s[0]: s[1] for s in rk.sites(part) + rk.loops(part)}
    fn_ops = function_ops(part, named.values())
    assert {site: fn_ops[fn] for site, fn in named.items()} == chip_smoke.rm_site_ops(part)
    assert fn_ops[named[next(s[0] for s in rk.sites(part) if s[2] == -0.8)]] == 2617


@pytest.mark.cuda
def test_the_work_run_is_chip_smokes_on_a_showerhead_frame():
    """On the card: the benchmark's work for one showerhead frame at the
    default view (512 x 512, aa 3) is chip_smoke's, counted and run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import bounds as smoke_bounds
    import chip_smoke
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from torch_bench.kinds.view import frames_work

    cell = config_cell("showerhead350")
    part, dev = program_part(cell), torch.device("cuda", 0)
    work = frames_work(part, [(0.6, 0.5)], 512, 512, 196, 3, 2.4, dev,
                       cell.config["ops_per_point"])
    rk.SHORT_CIRCUITS.clear()
    _, ev = rk.count_short_circuits(part, *chip_smoke.rm_args(part, 512, 512, 196, 3, dev))
    ops = smoke_bounds.raymarch_ops(part, int(ev.sum()), ev.numel())
    skipped = chip_smoke.rm_skipped_ops(chip_smoke.rm_site_ops(part), rk.SHORT_CIRCUITS)
    rk.SHORT_CIRCUITS.clear()
    assert (work["evaluations"], work["counted"], work["run"]) == (int(ev.sum()), ops,
                                                                    ops - skipped)
    assert 0 < work["run"] < work["counted"]
    nbytes = bounds.kernel_bytes("raymarch", pixels=512 * 512)
    smoke = smoke_bounds.bound(ops - skipped, nbytes)
    assert bounds.bound_s(work["run"], nbytes) * 1e3 == pytest.approx(smoke["published_fp32_ms"])
    assert 2 * bounds.bound_s(work["run"], nbytes) * 1e3 == pytest.approx(smoke["bound_ms"])


class _Twist:
    """A twist about z, the reference node a twisted part would bring: XY
    turned by k z."""

    WARPS = True

    def __init__(self, s, k):
        self.s, self.k = s, np.float32(k)

    def distance(self, p):
        a = self.k * p[..., 2]
        c, s = torch.cos(a), torch.sin(a)
        x, y = p[..., 0], p[..., 1]
        return self.s.distance(torch.stack([c * x - s * y, s * x + c * y, p[..., 2]], -1))

    def bounds(self):
        return self.s.bounds()


def _twisted_pair():
    from gsdf_tpu_torch import Builder
    from torch_bench.reference import sdf

    b = Builder()
    prog = b.translate(b.twist(b.new_cylinder(0.5, 1.0), 2.0), 0.2, 0.0, 0.0)
    ref = sdf.Translate(_Twist(sdf.Cylinder(0.5, 1.0), 2.0), [0.2, 0.0, 0.0])
    return ref, prog


@pytest.mark.parametrize("name,relax", [("showerhead350", 0.6), ("geb", 0.8),
                                        ("twist", 0.6)])
def test_the_references_relaxation_is_the_programs(name, relax):
    from gsdf_tpu_torch.visual.raymarch import auto_relax
    from torch_bench.reference import raymarch as rref

    if name == "twist":
        ref, prog = _twisted_pair()
    else:
        cell = config_cell(name)
        ref, prog = cell.reference.part(), program_part(cell)
    assert rref.relaxation(ref) == auto_relax(prog) == relax


# --- traffic ---------------------------------------------------------------
@pytest.mark.parametrize("mix", ["export", "edit", "view"])
def test_generator_is_reproducible_by_seed(mix):
    cell = cell_of({"export": "showerhead350.export", "edit": "flange400.edit",
                    "view": "showerhead350.view"}[mix])
    take = lambda s: list(itertools.islice(generator.requests(cell.mix, cell.config, s), 300))  # noqa: E731
    seed = 2**31 + 12345
    assert take(seed) == take(seed)
    if mix != "export":
        assert take(seed) != take(seed + 1)


def test_generator_gives_every_seed_the_same_strata():
    cell = spec.load("showerhead350.view")
    block = 16 * 8
    for seed in (1, 99, 2**33):
        views = list(itertools.islice(generator.requests(cell.mix, cell.config, seed), block))
        cells = {(int(v["yaw"] / (2 * math.pi) * 16), int((v["pitch"] + 1.2) / 2.4 * 8))
                 for v in views}
        assert len(cells) == block
    cell = cell_of("flange400.edit")
    edits = list(itertools.islice(generator.requests(cell.mix, cell.config, 7), 48))
    assert sorted(e["edit"]["name"] for e in edits) == sorted(
        [e["name"] for e in cell.config["edits"]] * 16)
    assert all(0 <= e["u"] <= 1 for e in edits)


# --- the definition ----------------------------------------------------------
def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        spec.reader(m["name"])
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        assert w["name"] in CELLS
        c = cell.config
        nx, ny, nz = c["cubes"]
        assert (nx + 1) * (ny + 1) * (nz + 1) == c["corners"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
    for name in CELLS:
        kinds.load(cell_of(name).mix["request"])
    with pytest.raises(SystemExit):
        kinds.load("no_such_kind")


def test_harness_and_control_never_ask_for_a_kind():
    # a request kind is one file under kinds/: the code that drives a run
    # calls its methods and names none of them
    for f in ("harness.py", "control.py", "run.py", "spec.py", "metrics/roofline.py"):
        with open(os.path.join(BENCH, f)) as fh:
            text = fh.read()
        for kind in READS:
            assert f'"{kind}"' not in text, (f, kind)


@pytest.mark.parametrize("name", ["flange400", "showerhead350"])
def test_reference_grid_is_the_flat_renderers(name):
    from gsdf_tpu_torch.render.flat import FlatRenderer

    cell = config_cell(name)
    ref, prog = cell.reference.part(), program_part(cell)
    rb, pb = ref.bounds(), prog.bounds()
    assert np.array_equal(rb[0], pb.min) and np.array_equal(rb[1], pb.max)
    g = mc.grid(rb, cell.config["resdiv"])
    fr = FlatRenderer(prog, pb.diagonal() / cell.config["resdiv"], "cpu")
    assert g.cubes == tuple(cell.config["cubes"]) == (fr.nx, fr.ny, fr.nz)
    assert g.res == fr.res and np.array_equal(g.origin, fr.origin)


def test_no_file_imports_jax_or_the_jax_package():
    # the run's files import none of these; a test of the benchmark may hold
    # its numbers to chip_smoke's, which no run loads
    for dirpath, _, files in os.walk(BENCH):
        banned = ("jax", "jaxlib", "flax", "gsdf_tpu", "bench")
        if os.path.relpath(dirpath, BENCH).split(os.sep)[0] != "tests":
            banned += ("chip_smoke",)
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                elif (isinstance(node, ast.Call) and node.args
                      and isinstance(node.args[0], ast.Constant)
                      and getattr(node.func, "attr", getattr(node.func, "id", None))
                      in ("import_module", "__import__")):
                    names = [str(node.args[0].value)]
                for n in names:
                    assert n.split(".")[0] not in banned, f"{f} imports {n}"


def test_the_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "gsdf_tpu_torch" not in fh.read(), f


# --- the run ---------------------------------------------------------------
def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "showerhead350.view", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_jax_and_the_jax_package_are_found_by_whole_top_level_names():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    assert run.barred_modules(["torch", "gsdf_tpu_torch", "gsdf_tpu_torch.eval",
                               "jaxtyping", "flaxen"]) == []
    assert run.barred_modules(["gsdf_tpu.eval.pallas_grid", "jax._src.api", "jaxlib",
                               "flax.linen", "torch"]) == ["flax", "gsdf_tpu", "jax", "jaxlib"]


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "torch_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "torch_bench/run.py", "--workload",
                           "showerhead350.view", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 5,
            "args": {"correlation": corr}}


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench.render", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "bench.stl", "ts": 400, "dur": 600},
        _launch(1, 90), _launch(2, 95),
        {"ph": "X", "cat": "kernel", "name": "eval_kernel", "ts": 100, "dur": 100,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "classify_kernel", "ts": 150, "dur": 60,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 260, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 300, "dur": 50},
    ]
    t = tr.reduce(ev, launches=1)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(110e-6 + 10e-6 + 50e-6)
    assert t.kernel_s == pytest.approx(170e-6)
    assert not t.lost and t.kernels == 2 and t.host_launches == 2 and t.unmatched == 0
    assert t.device_ops[0] == ["eval_kernel", pytest.approx(100e-6)]
    assert dict(t.idle_gaps)["stl"] == pytest.approx(600e-6)
    assert dict(t.idle_gaps)["render"] == pytest.approx(230e-6)
    assert not tr.reduce(ev, launches=2).lost
    # fewer launch calls than the wrappers launched: the host's events are lost
    assert tr.reduce(ev, launches=3).lost
    # no device event at all
    assert tr.reduce([e for e in ev if e["cat"] != "kernel"], launches=0).lost


def test_idle_gaps_go_to_the_innermost_benchmark_or_program_range():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench.frame", "ts": 100, "dur": 800},
        {"ph": "X", "cat": "user_annotation", "name": "gsdf.viewer.frame", "ts": 100,
         "dur": 700},
        {"ph": "X", "cat": "user_annotation", "name": "gsdf.raymarch.scene", "ts": 150,
         "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "gsdf.launch.raymarch", "ts": 250,
         "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "gsdf.viewer.fetch", "ts": 600,
         "dur": 200},
        {"ph": "X", "cat": "user_annotation", "name": "other.range", "ts": 0, "dur": 1000},
        _launch(1, 260),
        {"ph": "X", "cat": "kernel", "name": "raymarch", "ts": 300, "dur": 400,
         "args": {"correlation": 1}},
    ]
    t = tr.reduce(ev, launches=1)
    idle = dict(t.idle_gaps)
    assert idle == pytest.approx({"between requests": 200e-6, "viewer.frame": 110e-6,
                                  "raymarch.scene": 50e-6, "launch.raymarch": 40e-6,
                                  "viewer.fetch": 100e-6, "frame": 100e-6})
    # the idle share reads the device's union alone, whatever labels the gaps
    assert t.busy_s == pytest.approx(400e-6) and sum(idle.values()) == pytest.approx(600e-6)


def test_trace_with_one_of_two_kernels_of_a_launch_lost():
    # one wrapper launch (K1: eval and classify); the trace keeps the eval
    # kernel and loses the classify kernel. Counting kernels against wrapper
    # launches (1 <= 1) cannot see it; the launch call without its kernel does
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000},
        _launch(7, 10), _launch(8, 20),
        {"ph": "X", "cat": "kernel", "name": "eval_kernel", "ts": 100, "dur": 100,
         "args": {"correlation": 7}},
    ]
    t = tr.reduce(ev, launches=1)
    assert t.kernels == 1 and t.host_launches == 2 and t.unmatched == 1
    assert t.lost


def test_roofline_and_idle_share_read_the_trace():
    roof, _ = spec.reader("roofline.view")
    idle, _ = spec.reader("idle_share.view")
    trace = tr.Trace(2.0, 1.5, 1.2, 10, 10, 0, False, [], [])
    run = harness.Run(None, 1, 1.0, True)
    run.trace, run.device_bound_s = trace, 0.3
    assert roof.read(run, "view") == pytest.approx(25.0)
    assert idle.read(run, "view") == pytest.approx(25.0)
    run.device_bound_s = None
    assert roof.read(run, "view") is None
    run.device_bound_s, run.trace = 0.3, trace._replace(lost=True)
    assert roof.read(run, "view") is None and idle.read(run, "view") is None


FAULTS = {"export": ("half", "alter"), "edit": ("stale", "half"), "view": ("half", "alter")}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_cpu_run_is_correct(name):
    cell = small(name)
    result, run = harness.execute(cell, 2**32 + 5, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in READS[cell.mix["request"]]:
        mod, qualifier = spec.reader(m)
        value = mod.read(run, qualifier)
        assert value is not None and value > 0, m
    json.dumps(result)


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in FAULTS[cell_of(n).mix["request"]]])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    cell = small(name)
    result, _ = harness.execute(cell, 77, 0.3, False, "cpu", time.perf_counter(), fault=fault)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = small(name)
    numbers = control.control_numbers(cell, 3, "cpu")
    assert any(numbers[k] > cell.limits[k] for k in numbers), numbers
