"""The port's 2D image path and high-level pipeline against the JAX
package's on the CPU: render_distance_field (the pixel-grid kernel
K2-2D's plain version here), render_image_2d, the colour conversions of
render/image.py, PNG output, render_shader3d and the 2D example scenes.

JAX runs op by op (`jax.disable_jit`), as in the other test_torch_* files.
Tolerances: distance fields within 1e-6 (bit-identical where the tree has
no transcendental: asserted for the polygon profiles and the rectangle
recipes); the black-and-white image equal pixel for pixel; the IQ debug
palette within one level of 255 (its exp and cos run on distances that
may differ by an ulp).
"""
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.forge import threads as jax_threads
from gsdf_tpu.pipeline import RenderConfig as JaxRenderConfig
from gsdf_tpu.pipeline import render_shader3d as jax_render_shader3d
from gsdf_tpu.render import image as jax_image
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch import flagships, pipeline, render
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.eval import new_sdf2, point_kernels
from test_examples_smoke import EXAMPLES
from test_torch_nodes import JAX_KIT, NODE_CASES

W, H = 64, 48
CPU = jax.devices("cpu")[0]
SCENES = {name: fn for name, fn, _, _ in flagships.PNG_SCENES}
RECIPES = ["Difference2D", "Rotation2D", "CircularArray2D", "Ellipse2D", "Lines2D"]
#: no transcendental in the tree: the port's field equals the JAX one bit for bit
EXACT = {"plantpot", "showerhead-thread", "Difference2D", "Lines2D"}


def _jax_tree(name):
    if name in SCENES:
        return SCENES[name](JaxBuilder())  # the scenes reach only Builder methods
    return NODE_CASES[name](JaxBuilder(), JAX_KIT)


@pytest.fixture(scope="module")
def fields():
    """name -> (port tree, port field, JAX field) at 64 x 48."""
    out = {}
    for name in list(SCENES) + RECIPES:
        jtree = _jax_tree(name)
        ttree = from_reference_tree(jtree)
        with jax.disable_jit():
            ref = jax_image.render_distance_field(jtree, W, H, CPU)
        out[name] = (ttree, render.render_distance_field(ttree, W, H, "cpu"), ref)
    return out


@pytest.mark.parametrize("name", list(SCENES) + RECIPES)
def test_distance_field_matches_jax(name, fields):
    _, got, ref = fields[name]
    assert got.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if name in EXACT:
        np.testing.assert_array_equal(got, ref)
    assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("name", list(SCENES) + RECIPES)
def test_bw_image_matches_jax_pixel_for_pixel(name, fields):
    ttree, got, ref = fields[name]
    img = render.render_image_2d(ttree, W, H, device="cpu")
    assert img.shape == (H, W, 4) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jax_image.bw_conversion(ref))
    np.testing.assert_array_equal(img, render.bw_conversion(got))
    inside = got <= 0
    assert (img[inside, :3] == 0).all() and (img[~inside, :3] == 255).all()
    assert (img[..., 3] == 255).all()


def test_pixel_positions_equal_numpy():
    """The pixels' positions are the float32 values numpy makes
    (gsdf_tpu/render/image.py:64-69): the field equals the point
    evaluator's on that positions array bit for bit, row 0 at the top."""
    tree = flagships.mandala_scene2d(TorchBuilder())
    bb = tree.bounds()
    f32 = np.float32
    dx, dy = f32(bb.size()[0]) / f32(W), f32(bb.size()[1]) / f32(H)
    xmin, ymax = f32(bb.min[0]) + dx / 2, f32(bb.max[1])
    got = tuple(point_kernels.pixel_grid(tree, W, H))
    assert got == (xmin, ymax, dx, dy) and all(type(v) is np.float32 for v in got)
    xs = xmin + np.arange(W, dtype=f32) * dx
    ys = ymax - np.arange(H, dtype=f32) * dy
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1).reshape(-1, 2)
    field = render.render_distance_field(tree, W, H, "cpu")
    np.testing.assert_array_equal(field, new_sdf2(tree, "cpu").evaluate(pts).reshape(H, W))
    plain = point_kernels.distance_field_plain(tree, W, H, "cpu")
    assert plain.shape == (H, W) and torch.equal(plain, torch.from_numpy(field))
    assert field[0, W // 2] > 0 and ys[0] > ys[-1]  # the top row lies outside, above


def test_distance_field_rejects_bad_input():
    b = TorchBuilder()
    with pytest.raises(TypeError, match="Shader2D"):
        render.render_distance_field(b.new_sphere(1.0), 8, 8, "cpu")
    for w, h in ((0, 8), (8, 0), (-1, 4)):
        with pytest.raises(ValueError, match="empty image"):
            render.render_distance_field(b.new_circle(1.0), w, h, "cpu")


def test_iq_debug_conversion_within_one_level(fields):
    _, got, ref = fields["mandala"]
    img = render.iq_debug_conversion(got, 2.0)
    want = jax_image.iq_debug_conversion(ref, 2.0)
    assert img.shape == (H, W, 4) and img.dtype == np.uint8
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
    # the conversion itself is the same numpy: equal on equal input
    np.testing.assert_array_equal(render.iq_debug_conversion(ref), jax_image.iq_debug_conversion(ref))
    custom = render.render_image_2d(fields["mandala"][0], W, H, render.iq_debug_conversion, "cpu")
    np.testing.assert_array_equal(custom, render.iq_debug_conversion(got))


def test_bw_conversion_marks_bad_values_red():
    d = np.array([[-1.0, 0.0, 2.0], [np.nan, np.inf, -np.inf]], np.float32)
    img = render.bw_conversion(d)
    np.testing.assert_array_equal(img, jax_image.bw_conversion(d))
    np.testing.assert_array_equal(img[0, :, 0], [0, 0, 255])
    np.testing.assert_array_equal(img[1], [(255, 0, 0, 255)] * 3)


def test_png_written_and_read_back(tmp_path):
    from PIL import Image

    tree = flagships.plantpot_profile(TorchBuilder())
    path = str(tmp_path / "pot.png")
    img = pipeline.render_png_file_2d(path, tree, W, H, device="cpu")
    np.testing.assert_array_equal(img, render.render_image_2d(tree, W, H, device="cpu"))
    with Image.open(path) as f:
        assert f.mode == "RGBA" and f.size == (W, H)
        np.testing.assert_array_equal(np.asarray(f), img)
    path2 = str(tmp_path / "iq.png")
    iq = render.iq_debug_conversion(render.render_distance_field(tree, W, H, "cpu"), 10.0)
    render.write_png(path2, iq)
    with Image.open(path2) as f:
        np.testing.assert_array_equal(np.asarray(f), iq)


@pytest.mark.parametrize("name", ["flange", "bolt"])
def test_render_shader3d_stats_match_jax(name, capsys):
    """The pipeline's compact render at smoke resolution: triangle count,
    evaluations and STL size equal to the JAX package's."""
    jtree = getattr(jax_flagships, f"build_{name}")()
    res = float(jtree.bounds().diagonal() / 40)
    ref_out, out = io.BytesIO(), io.BytesIO()
    ref = jax_render_shader3d(
        jtree, JaxRenderConfig(stl_output=ref_out, resolution=res, silent=True, device=CPU))
    capsys.readouterr()
    stats = pipeline.render_shader3d(
        from_reference_tree(jtree),
        pipeline.RenderConfig(stl_output=out, resolution=res, device="cpu"))
    lines = capsys.readouterr().out.splitlines()
    assert stats["triangles"] == ref["triangles"] > 1000
    assert stats["evaluations"] == ref["evaluations"]
    assert stats["stl_bytes"] == ref["stl_bytes"] == len(out.getvalue()) == 84 + 50 * stats["triangles"]
    np.testing.assert_array_equal(stats["tri_idx"], ref["tri_idx"])
    # the JAX render is jitted here (XLA-CPU contracts multiply-adds): vertices
    # move by a few ulp of the part's 30 mm, the connectivity not at all
    np.testing.assert_allclose(stats["verts"], ref["verts"], rtol=0, atol=1e-4)
    assert len(lines) == 3 and "renderer init (grid" in lines[0]
    assert f"generated {stats['triangles']} triangles" in lines[1] and "bytes STL" in lines[2]


def test_render_shader3d_options():
    ball = TorchBuilder().new_sphere(1.0)
    with pytest.raises(ValueError, match="resolution"):
        pipeline.render_shader3d(ball, pipeline.RenderConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="visual/shadertoy.py"):
        pipeline.render_shader3d(ball, pipeline.RenderConfig(
            resolution=0.2, visual_output=io.StringIO(), device="cpu"))
    # use_gpu=False is the CPU, as in the JAX package; no STL asked for, none written
    stats = pipeline.render_shader3d(
        ball, pipeline.RenderConfig(resolution=0.2, use_gpu=False, silent=True))
    assert stats["triangles"] == len(stats["tri_idx"]) > 100 and "stl_bytes" not in stats
    assert [f.name for f in dataclasses.fields(pipeline.RenderConfig)] == \
        [f.name for f in dataclasses.fields(JaxRenderConfig)]


def test_png_scenes_are_the_examples(monkeypatch):
    """The port's copies of the example programs' 2D scenes hash as the
    examples' own (examples/plantpot.py, ui_mandala.py) and as the JAX
    showerhead's thread profile; `showerhead_scene` takes `thread_png`
    again and builds the same part with it."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    import plantpot
    import ui_mandala

    tb = TorchBuilder()
    assert flagships.mandala_scene2d(tb).tree_hash() == ui_mandala.scene2d(JaxBuilder()).tree_hash()
    pot = tb.revolve(flagships.plantpot_profile(tb), 0)
    assert pot.tree_hash() == plantpot.scene_pot_base(JaxBuilder()).tree_hash()
    thread = jax_threads.PlasticButtress(d=65.0, p=5.0 / 3.0).thread(JaxBuilder())
    assert flagships.showerhead_thread_profile(tb).tree_hash() == thread.tree_hash()
    assert [(n, w, h) for n, _, w, h in flagships.PNG_SCENES] == [
        ("plantpot", 1080, 1080), ("mandala", 768, 768), ("showerhead-thread", 512, 512)]

    calls = []
    monkeypatch.setattr(pipeline, "render_png_file_2d", lambda *a, **k: calls.append((a, k)))
    with_png = flagships.showerhead_scene(TorchBuilder(), thread_png="thread.png")
    assert with_png.tree_hash() == flagships.build_showerhead().tree_hash()
    (path, profile, w, h), kw = calls[0]
    assert (path, w, h, kw) == ("thread.png", 512, 512, {})
    assert profile.tree_hash() == thread.tree_hash()
