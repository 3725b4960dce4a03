"""CPU tests of the `geb` configuration: its plain reference against the
program's plain tree, and its frozen numbers. Its cell `geb.view` runs
sound, with planted faults and as the control in test_bench.py, which
takes every cell that has limits (`CELLS`, read from limits/).

    python -m pytest torch_bench/tests/test_geb.py -q
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from torch_bench import bounds, kinds, spec
from torch_bench.reference import raymarch as rref
from torch_bench.reference import sdf, text

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def geb():
    cell = spec.make("geb.view", "geb", "view")
    return cell, cell.reference.part(), kinds.program_attr(cell.config["builder"])()


def test_the_cell_is_in_the_benchmark_with_its_limits():
    """test_bench.py's CELLS are the files under limits/: geb.view's is one."""
    assert os.path.exists(os.path.join(BENCH, "limits", "geb.view.json"))
    cell = spec.load("geb.view")
    assert cell.config["name"] == "geb" and cell.mix["request"] == "view" and cell.chips == 1


def test_reference_and_program_reproduce_the_frozen_ops_per_point(geb):
    cell, ref, prog = geb
    frozen = cell.config["ops_per_point"]
    assert bounds.ops_per_point(ref, ref.bounds()) == frozen
    bb = prog.bounds()
    assert bounds.ops_per_point(prog, (bb.min, bb.max)) == frozen


def test_the_frozen_tree_numbers(geb):
    cell, _, prog = geb
    c = cell.config
    visits = lambda n: 1 + sum(visits(k) for k in n.children())  # noqa: E731
    unique = {id(n): n for n in prog.visit_bfs()}
    verts = {id(n): len(n.vert) for n in unique.values() if type(n).__name__ == "Polygon2D"}
    assert visits(prog) == c["nodes"]
    assert len(unique) == c["unique_nodes"]
    assert sum(verts.values()) == c["polygon_vertices"]


def test_reference_distances_equal_the_programs(geb):
    """Seeded points in and around the part's box. Tolerance 0: both
    evaluate the same float32 operations in the same order on the CPU
    (each square root rounded once from float64 on both sides), so equal
    vertices give equal distances bit for bit."""
    _, ref, prog = geb
    lo, hi = (torch.as_tensor(b) for b in ref.bounds())
    g = torch.Generator().manual_seed(2**32 + 16)
    pts = lo - 0.05 + (hi - lo + 0.1) * torch.rand((30000, 3), generator=g)
    d_ref, d_prog = ref.distance(pts), prog.distance(pts)
    assert torch.equal(d_ref, d_prog)
    assert 0 < int((d_ref < 0).sum()) < len(pts)


def test_reference_box_is_the_programs(geb):
    """The camera frames the part by its box: the same box, float for
    float, gives the same rays."""
    _, ref, prog = geb
    rb, pb = ref.bounds(), prog.bounds()
    assert np.array_equal(rb[0], pb.min) and np.array_equal(rb[1], pb.max)


def test_reference_glyphs_are_the_programs(geb):
    """The reference's own flattening gives the program's float32 contours
    for every basic glyph, from the same TTF file."""
    cell, _, _ = geb
    from gsdf_tpu_torch.forge.textsdf import Font
    from gsdf_tpu_torch.forge.textsdf import font as port_font

    path = cell.reference.font_path()
    assert os.path.samefile(path, port_font.EMBEDDED_FONT_PATH)
    f = Font()
    f.load_default()
    for code in range(port_font.FIRST_BASIC, port_font.LAST_BASIC + 1):
        c = chr(code)
        want = port_font.glyph_contours(f._glyphset, f._glyph_name(c), f._scaleout(), 0.01)
        got = text.glyph_polygons(path, c, 0.01)
        assert len(got) == len(want), c
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=c)


def test_reference_needs_no_font_package(geb, monkeypatch):
    """The reference reads the TTF itself: with fontTools unimportable it
    builds the same part."""
    cell, ref, _ = geb
    monkeypatch.setitem(sys.modules, "fontTools", None)
    again = cell.reference.part()
    pts = torch.rand((512, 3), generator=torch.Generator().manual_seed(16)) * 0.3 - 0.1
    assert torch.equal(again.distance(pts), ref.distance(pts))


def test_relaxation_is_the_programs(geb):
    from gsdf_tpu_torch.visual.raymarch import auto_relax

    _, ref, prog = geb
    assert rref.relaxation(ref) == auto_relax(prog) == 0.8


def test_transform_and_rotation_nodes():
    """A Transform maps the point by the inverse matrix and the box by the
    matrix; a quarter turn about z takes +x to +y."""
    box = sdf.Translate(sdf.Cylinder(0.5, 1.0), [1.0, 0.0, 0.0])
    turned = text.Rotate(box, np.pi / 2, (0, 0, 1))
    p = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    d = turned.distance(p)
    assert d[0] == pytest.approx(-0.5, abs=1e-6) and d[1] > 0
    lo, hi = turned.bounds()
    np.testing.assert_allclose(lo, [-0.5, 0.5, -0.5], atol=1e-6)
    np.testing.assert_allclose(hi, [0.5, 1.5, 0.5], atol=1e-6)
    stretched = text.Transform(box, text.scaling(2, 1, 1))
    assert stretched.distance(torch.tensor([[2.0, 0.0, 0.0]]))[0] == pytest.approx(-0.5)
