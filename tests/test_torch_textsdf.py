"""The port's text (gsdf_tpu_torch.forge.textsdf) against the JAX package's
on the CPU: the vendored font byte for byte, the port's own TrueType
reader against fontTools (every glyph's pen calls, the cmap, the metrics),
the port built and used with fontTools unimportable, every basic glyph's float32
contours, the 'Abp8' goldens of tests/test_textsdf_golden.py (bounds,
inside samples, the extruded triangle count through the port's
FlatRenderer), the tree hashes of a text line and of the GEB sculpture of
examples/ui_geb.py, the errors, the spans and counters, and that the
showerhead's path never imports textsdf or fontTools.

JAX runs op by op (`jax.disable_jit`), as in the other test_torch_* files,
on one pinned 96 x 48 grid.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.forge.textsdf import Font as JaxFont
from gsdf_tpu.forge.textsdf import font as jax_font
from gsdf_tpu_torch import Builder, flagships, spans
from gsdf_tpu_torch.forge import textsdf
from gsdf_tpu_torch.forge.textsdf import Font, FontConfig
from gsdf_tpu_torch.forge.textsdf import font as port_font
from gsdf_tpu_torch.forge.textsdf import sfnt
from gsdf_tpu_torch.render.flat import FlatRenderer
from test_examples_smoke import EXAMPLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIC = [chr(c) for c in range(port_font.FIRST_BASIC, port_font.LAST_BASIC + 1)]


@pytest.fixture(scope="module")
def fonts():
    port, ref = Font(), JaxFont()
    port.load_default()
    ref.load_default()
    return port, ref


def _abp8(font):
    return font.text_line("Abp8")


def test_vendored_font_is_the_jax_packages():
    """The port ships its own copy of the font and its licence, byte for
    byte the JAX package's, and loads it from its own directory."""
    here = os.path.join(REPO, "gsdf_tpu_torch", "forge", "textsdf", "vendored")
    assert os.path.dirname(port_font.EMBEDDED_FONT_PATH) == here
    assert port_font.DEFAULT_FONT_PATHS[0] == port_font.EMBEDDED_FONT_PATH
    for name in ("DejaVuSans-ascii.ttf", "LICENSE-DejaVu.txt"):
        with open(os.path.join(here, name), "rb") as f, \
                open(os.path.join(os.path.dirname(jax_font.EMBEDDED_FONT_PATH), name), "rb") as g:
            assert f.read() == g.read(), name


def test_reader_draws_every_glyph_as_fonttools():
    """Every glyph of the vendored font reaches a pen as the same calls with
    the same points as fontTools' glyph set draws it; the best cmap, the
    advance widths and the head's box and units are fontTools'."""
    from fontTools.pens.recordingPen import RecordingPen
    from fontTools.ttLib import TTFont

    with open(port_font.EMBEDDED_FONT_PATH, "rb") as f:
        ttf = sfnt.TrueType(f.read())
    ref = TTFont(port_font.EMBEDDED_FONT_PATH)
    order, glyphs = ref.getGlyphOrder(), ref.getGlyphSet()
    assert ttf.cmap == {c: order.index(n) for c, n in ref.getBestCmap().items()}
    head = ref["head"]
    assert ttf.bbox == (head.xMin, head.yMin, head.xMax, head.yMax)
    assert ttf.units_per_em == head.unitsPerEm
    assert len(order) == len(ttf.metrics) > 100
    for gid, name in enumerate(order):
        want, got = RecordingPen(), port_font._RecordingPen()
        glyphs[name].draw(want)
        ttf[gid].draw(got)
        assert got.value == want.value, name
        assert ttf[gid].width == glyphs[name].width, name
    assert ttf.kern(1, 2) == 0  # the subset has no kern table


def test_reader_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="CFF"):
        sfnt.TrueType(b"OTTO" + bytes(64))
    with pytest.raises(ValueError, match="not a TrueType font"):
        Font().load_ttf_bytes(b"\x00\x00\x00\x00" + bytes(64))


def test_text_needs_no_font_package():
    """With fontTools unimportable, the GEB sculpture builds and hashes as
    with it: the port needs no font package."""
    code = ("import sys\n"
            "sys.modules['fontTools'] = None\n"
            "from gsdf_tpu_torch import flagships\n"
            "print(flagships.build_geb().tree_hash().hex())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == flagships.build_geb().tree_hash().hex()


@pytest.mark.parametrize("tol", [0.15, 0.01])
def test_every_basic_glyph_has_the_jax_contours(fonts, tol):
    port, ref = fonts
    assert port._scaleout() == ref._scaleout()
    for c in BASIC:
        got = port_font.glyph_contours(port._glyphset, port._glyph_name(c), port._scaleout(), tol)
        want = jax_font.glyph_contours(ref._glyphset, ref._glyph_name(c), ref._scaleout(), tol)
        assert len(got) == len(want), c
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=c)


def test_every_basic_glyph_hashes_as_the_jax_one(fonts):
    port, ref = fonts
    for c in BASIC:
        assert port.glyph(c).tree_hash() == ref.glyph(c).tree_hash(), c
    assert port.advance_width("A") == ref.advance_width("A")
    assert port.kern("A", "V") == ref.kern("A", "V")


def test_abp8_fingerprint(fonts):
    """The JAX package's golden (tests/test_textsdf_golden.py): the line's
    bounds within 1e-6 and 762 samples inside on its 96 x 48 grid; the
    port's distances there equal the JAX package's within 1e-6 (sqrt of
    the same float32 sums: bit for bit, asserted)."""
    port, ref = fonts
    line, jline = _abp8(port), _abp8(ref)
    assert line.tree_hash() == jline.tree_hash()
    bb = line.bounds()
    np.testing.assert_allclose([bb.min[0], bb.min[1], bb.max[0], bb.max[1]],
                               [0.00460829, -0.12269586, 1.4873272, 0.44815668], atol=1e-6)
    xs = np.linspace(bb.min[0] - 0.1, bb.max[0] + 0.1, 96, dtype=np.float32)
    ys = np.linspace(bb.min[1] - 0.1, bb.max[1] + 0.1, 48, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
    d = line.distance(torch.from_numpy(pts)).numpy()
    assert int((d < 0).sum()) == 762
    assert np.isfinite(d).all()
    with jax.disable_jit():
        want = np.asarray(jline.distance(pts))
    np.testing.assert_array_equal(d, want)


def test_abp8_extruded_triangle_golden(fonts):
    ex = Builder().extrude(_abp8(fonts[0]), 0.3)
    tris = FlatRenderer(ex, ex.bounds().diagonal() / 150, "cpu").render()
    assert len(tris) == 61700


def test_all_offcurve_contour():
    """A contour of off-curve points only (qCurveTo(..., None) with no
    moveTo): its implied start is the midpoint of the last and first
    off-curve points, never the previous contour's end; the port's
    contour equals the JAX package's."""

    class _Glyph:
        def draw(self, pen):
            pen.value = [("qCurveTo", ((10, 0), (0, 10), (-10, 0), (0, -10), None)),
                         ("closePath", ())]

    got = port_font.glyph_contours({"dot": _Glyph()}, "dot", 1.0, 0.05)
    want = jax_font.glyph_contours({"dot": _Glyph()}, "dot", 1.0, 0.05)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    r = np.linalg.norm(got[0], axis=1)
    assert r.min() > 4.0 and r.max() < 10.5
    assert abs(port_font.signed_area(got[0])) > 50


def test_errors_are_the_jax_packages(fonts):
    port, _ = fonts
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="relative_glyph_tolerance"):
            Font().configure(FontConfig(relative_glyph_tolerance=bad))
    with pytest.raises(ValueError, match="not graphic"):
        port.text_line("a\nb")
    with pytest.raises(ValueError, match="no text"):
        port.text_line("  ")
    with pytest.raises(ValueError, match="has no glyph"):
        port.glyph("中")
    f = Font()
    f.configure(FontConfig(relative_glyph_tolerance=0.01, builder=Builder()))
    assert f.reltol == 0.01 and Font().reltol == 0.15


def test_geb_is_the_examples_scene(monkeypatch):
    """build_geb() hashes as examples/ui_geb.py's scene, with its bounds."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    import ui_geb

    port, jax_tree = flagships.build_geb(), ui_geb.scene(JaxBuilder())
    assert port.tree_hash() == jax_tree.tree_hash()
    np.testing.assert_array_equal(port.bounds().min, np.asarray(jax_tree.bounds().min))
    np.testing.assert_array_equal(port.bounds().max, np.asarray(jax_tree.bounds().max))


def test_spans_and_counters_of_a_glyph():
    """`textsdf.load` once a font, `textsdf.glyph` once a glyph built (not
    for one taken from the cache); COUNTS adds glyphs, contours and
    vertices."""
    spans.clear()
    before = dict(textsdf.COUNTS)
    with spans.recording():
        f = Font()
        f.load_default()
        b = f.glyph("B")
        assert f.glyph("B") is b
        f.glyph("G")
    s = spans.summary()
    assert s["textsdf.load"]["count"] == 1 and s["textsdf.glyph"]["count"] == 2
    contours = [port_font.glyph_contours(f._glyphset, f._glyph_name(c), f._scaleout(), f.reltol)
                for c in "BG"]
    assert textsdf.COUNTS["glyphs"] - before["glyphs"] == 2
    assert textsdf.COUNTS["contours"] - before["contours"] == sum(map(len, contours)) == 4
    assert textsdf.COUNTS["vertices"] - before["vertices"] == sum(
        len(c) for cs in contours for c in cs)
    spans.clear()


def test_the_showerhead_path_imports_no_text():
    """Building the showerhead and its viewer imports neither textsdf nor
    fontTools: the showerhead cell's set-up does not pay for them."""
    code = ("import sys\n"
            "from gsdf_tpu_torch import flagships\n"
            "from gsdf_tpu_torch.pipeline.interactive import InteractiveViewer\n"
            "flagships.build_showerhead()\n"
            "bad = [m for m in sys.modules if 'textsdf' in m or m.split('.')[0] == 'fontTools']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
