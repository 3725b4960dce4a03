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
    banned = ("jax", "gsdf_tpu", "chip_smoke", "bench")
    for dirpath, _, files in os.walk(BENCH):
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
