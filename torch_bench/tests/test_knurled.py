"""CPU tests of the `knurled350` configuration: its plain reference against
the program's plain tree, node by node and whole, its frozen numbers, and
the reader of `march_evals`. Its cell `knurled350.view` runs sound, with
planted faults and as the control in test_bench.py, which takes every cell
that has limits (`CELLS`, read from limits/).

    python -m pytest torch_bench/tests/test_knurled.py -q
"""
from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from torch_bench import bounds, harness, kinds, spec
from torch_bench.reference import knurl, mc, sdf, text
from torch_bench.reference import raymarch as rref

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def knurled():
    cell = spec.make("knurled350.view", "knurled350", "view")
    return cell, cell.reference.part(), kinds.program_attr(cell.config["builder"])()


def _points(box, n, seed, pad=0.05):
    """n seeded points in the box grown by `pad` of its size on each side."""
    lo, hi = (torch.as_tensor(b, dtype=torch.float32) for b in box)
    grow = (hi - lo) * pad
    g = torch.Generator().manual_seed(seed)
    return lo - grow + (hi - lo + 2 * grow) * torch.rand((n, 3), generator=g)


def test_the_cell_is_in_the_benchmark_with_its_limits():
    """test_bench.py's CELLS are the files under limits/: knurled350.view's
    is one, with the view kind's one compared number."""
    assert os.path.exists(os.path.join(BENCH, "limits", "knurled350.view.json"))
    cell = spec.load("knurled350.view")
    assert cell.config["name"] == "knurled350" and cell.mix["request"] == "view"
    assert cell.chips == 1 and set(cell.limits) == {"px_off_share"}
    assert "march_evals.view" in [m["name"] for m in cell.per_layer]
    assert "frame_p95_ms" in [m["name"] for m in cell.end_to_end]


def test_reference_and_program_reproduce_the_frozen_ops_per_point(knurled):
    cell, ref, prog = knurled
    frozen = cell.config["ops_per_point"]
    assert frozen == 421
    assert bounds.ops_per_point(ref, ref.bounds()) == frozen
    bb = prog.bounds()
    assert bounds.ops_per_point(prog, (bb.min, bb.max)) == frozen


def test_the_frozen_tree_numbers(knurled):
    """23 node visits (the knurl's ring and the vent are each shared by two
    parents), 17 nodes; the parametric vector a launch reads holds 162
    floats; no short-circuit site and no loop in the baked source."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.eval.parametric import kernel_params

    cell, _, prog = knurled
    c = cell.config
    visits = lambda n: 1 + sum(visits(k) for k in n.children())  # noqa: E731
    assert visits(prog) == c["nodes"] == 23
    assert len({id(n) for n in prog.visit_bfs()}) == c["unique_nodes"]
    assert kernel_params(prog).size == c["continuous_parameters"]
    assert rk.sites(prog) == [] and rk.loops(prog) == []


def test_reference_distances_equal_the_programs(knurled):
    """Seeded points in and around the part's box. Tolerance 0: both
    evaluate the same float32 operations in the same order on the CPU
    (each square root, sine and cosine rounded once from float64 on both
    sides, atan2 torch's float32 one on both), so they agree bit for bit.
    The part evaluated on bfloat16 points is off by far more."""
    _, ref, prog = knurled
    pts = _points(ref.bounds(), 40000, 2**32 + 21)
    d_ref, d_prog = ref.distance(pts), prog.distance(pts)
    assert torch.equal(d_ref, d_prog)
    assert 0 < int((d_ref < 0).sum()) < len(pts)
    coarse = ref.distance(pts.bfloat16()).float()
    assert not torch.equal(coarse, d_prog) and float((coarse - d_prog).abs().max()) > 1e-2


def test_reference_box_is_the_programs(knurled):
    """The camera frames the part by its box: the same box, float for
    float, gives the same rays; at resdiv 350 it is the configuration's
    grid."""
    cell, ref, prog = knurled
    rb, pb = ref.bounds(), prog.bounds()
    assert np.array_equal(rb[0], pb.min) and np.array_equal(rb[1], pb.max)
    g = mc.grid(rb, cell.config["resdiv"])
    nx, ny, nz = g.cubes
    assert list(g.cubes) == cell.config["cubes"]
    assert (nx + 1) * (ny + 1) * (nz + 1) == cell.config["corners"]


def test_relaxation_is_the_programs(knurled):
    """Both twists warp the domain: both sides march at 0.6."""
    from gsdf_tpu_torch.visual.raymarch import auto_relax

    _, ref, prog = knurled
    assert rref.relaxation(ref) == auto_relax(prog) == 0.6


def _node_pairs():
    """(name, reference node, program node) of each reference node the part
    brings, alone, at the part's sizes and at others."""
    from gsdf_tpu_torch import Builder

    b = Builder()
    tooth = (knurl.Box(10, 10, 40, 0), b.new_box(10, 10, 40, 0))
    rounded = (knurl.Box(1.0, 0.8, 0.6, 0.1), b.new_box(1.0, 0.8, 0.6, 0.1))
    turned = (text.Rotate(tooth[0], math.pi / 4, (0, 0, 1)),
              b.rotate(tooth[1], math.pi / 4, (0, 0, 1)))
    moved = (sdf.Translate(turned[0], [16.0, 0, 0]), b.translate(turned[1], 16.0, 0, 0))
    ring = (knurl.CircularArray(moved[0], 24, 24), b.circular_array(moved[1], 24, 24))
    part_ring = (knurl.CircularArray(sdf.Translate(rounded[0], [2.0, 0.5, 0]), 5, 8),
                 b.circular_array(b.translate(rounded[1], 2.0, 0.5, 0), 5, 8))
    body = (sdf.Cylinder(10, 50, 1.0), b.new_cylinder(10, 50, 1.0))
    return [
        ("box", *tooth), ("rounded box", *rounded), ("rotation", *turned),
        ("circular array", *ring), ("circular array, 5 of 8", *part_ring),
        ("twist", knurl.Twist(ring[0], 0.075), b.twist(ring[1], 0.075)),
        ("twist back", knurl.Twist(rounded[0], -2.0), b.twist(rounded[1], -2.0)),
        ("smooth difference", knurl.SmoothDifference(1.0, body[0], moved[0]),
         b.smooth_difference(1.0, body[1], moved[1])),
    ]


@pytest.mark.parametrize("i", range(8))
def test_each_reference_node_is_the_programs(i):
    """Each new node alone, bit for bit on seeded points around its box
    (the reasons of test_reference_distances_equal_the_programs), and its
    box float for float."""
    name, ref, prog = _node_pairs()[i]
    rb, pb = ref.bounds(), prog.bounds()
    assert np.array_equal(rb[0], pb.min) and np.array_equal(rb[1], pb.max), name
    pts = _points(rb, 20000, 2**31 + 7 * i, pad=0.25)
    d_ref, d_prog = ref.distance(pts), prog.distance(pts)
    assert torch.equal(d_ref, d_prog), name
    assert 0 < int((d_ref < 0).sum()) < len(pts), name
    assert bounds.ops_per_point(ref, rb) == bounds.ops_per_point(prog, (pb.min, pb.max)), name


# --- the reader of march_evals ------------------------------------------------
def _run(completed):
    run = harness.Run(None, 1, 1.0, True)
    run.completed = completed
    return run


def test_march_evals_reads_the_programs_counter(monkeypatch):
    from gsdf_tpu_torch.eval import ray_kernels as rk

    reader, qualifier = spec.reader("march_evals.view")
    assert qualifier == "view"
    monkeypatch.setattr(rk, "MARCH", {"frames": 4, "rays": 1000, "evaluations": 23500})
    assert reader.read(_run(4), qualifier) == pytest.approx(23.5)
    # frames other than the window's: the count is not of this window
    assert reader.read(_run(5), qualifier) is None
    monkeypatch.setattr(rk, "MARCH", {"frames": 0, "rays": 0, "evaluations": 0})
    assert reader.read(_run(0), qualifier) is None
    monkeypatch.delattr(rk, "MARCH")  # a program without the counter
    assert reader.read(_run(4), qualifier) is None


def test_count_work_fills_the_counter_the_reader_reads(knurled, monkeypatch):
    """After the window the view kind takes its frames again through
    raymarch(..., evals=True) (the plain version here, on small frames):
    the counter then holds those frames, and the reader their evaluations
    a ray, each ray's 5 of shading among them."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from torch_bench.kinds.view import Kind

    cell, _, prog = knurled
    small = cell._replace(mix={**cell.mix, "frame": {"width": 20, "height": 16, "aa": 2,
                                                     "steps": 48}})
    monkeypatch.setattr(rk, "MARCH", {"frames": 0, "rays": 0, "evaluations": 0})
    kind = Kind(small, prog, "cpu")
    kind.frames[:] = [(0.0, 0.0), (0.6, 0.5), (3.5, -0.8)]  # the first is before the mark
    kind.count_work((0, 1))
    assert rk.MARCH["frames"] == 2 and rk.MARCH["rays"] == 2 * 40 * 32
    reader, qualifier = spec.reader("march_evals.view")
    evals_a_ray = reader.read(_run(2), qualifier)
    assert evals_a_ray == rk.MARCH["evaluations"] / rk.MARCH["rays"] and 6 < evals_a_ray < 53
