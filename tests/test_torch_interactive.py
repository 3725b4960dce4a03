"""The port's interactive viewer (pipeline/interactive.py) on the CPU: the
ten tests of tests/test_interactive.py, each on the port with
device="cpu" (orbit, zoom, motion-adaptive quality, the Agg event pump,
drag pipelining one frame behind, the parametric slider with no new
library and its ValueError), interactive_view's turntable fallback
(taken where there is no display, and only there), and the viewer's frames against the JAX
package's viewer at the same views (JAX op by op, `jax.disable_jit`):
within one level, none past it (as found)."""
import jax
import numpy as np
import pytest

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.pipeline import InteractiveViewer as JaxViewer
from gsdf_tpu_torch import Builder, _build, kernels
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.pipeline import InteractiveViewer

CPU = "cpu"


def _obj(b):
    return b.smooth_union(0.1, b.new_sphere(0.7), b.new_box(1, 1, 0.4, 0))


def _viewer():
    return InteractiveViewer(_obj(Builder()), width=64, height=64, steps=48, drag_steps=16,
                             device=CPU)


def test_orbit_and_zoom_change_view():
    v = _viewer()
    img0 = v.render_current("full")
    assert img0.shape == (64, 64, 3) and img0.dtype == np.uint8
    v.on_press(10, 10)
    assert v.on_move(30, 18)  # drag -> view changed
    v.on_release()
    img1 = v.render_current("full")
    assert not np.array_equal(img0, img1)
    yaw_before = v.yaw
    assert v.on_scroll(2)
    assert v.cam_dist < 2.4 and v.yaw == yaw_before


def test_drag_quality_is_cheap_but_full_size():
    v = _viewer()
    img = v.render_current("drag")
    # half-res render, upscaled to the window size
    assert img.shape == (64, 64, 3)
    np.testing.assert_array_equal(img[::2, ::2], img[1::2, 1::2])


def test_rest_quality_defaults_reference_parity():
    """Rest frames default to aa=3 supersampling (the reference UI's
    AA-at-rest, gsdfaux/ui.go:131-241); drag frames render aa=1 at half
    resolution. The aa*W x aa*H frame is box-filtered on the device, so the
    fetched image is the window size for any aa."""
    v = _viewer()
    assert v.aa == 3
    img = v.render_current("full")
    assert img.shape == (64, 64, 3)
    # aa=1 viewer produces the same geometry but visibly different edge
    # pixels (the supersample filter is real, not a no-op)
    v1 = InteractiveViewer(_obj(Builder()), width=64, height=64, steps=48, aa=1, device=CPU)
    img1 = v1.render_current("full")
    assert not np.array_equal(img, img1)


def test_move_without_press_is_noop():
    v = _viewer()
    assert not v.on_move(5, 5)
    v.reset()
    assert (v.yaw, v.pitch, v.cam_dist) == (0.6, 0.5, 2.4)


def test_pitch_clamped():
    v = _viewer()
    v.on_press(0, 0)
    v.on_move(0, 10000)
    assert abs(v.pitch) <= 1.45


def test_auto_relax_detects_warped_trees():
    from gsdf_tpu_torch.forge import threads
    from gsdf_tpu_torch.visual.raymarch import auto_relax

    bld = Builder()
    plain = bld.union(bld.new_sphere(1.0), bld.new_box(1, 1, 1, 0))
    assert auto_relax(plain) == 0.8
    twisted = bld.twist(bld.new_box(1, 1, 1, 0), 0.5)
    assert auto_relax(twisted) == 0.6
    screw = threads.screw(bld, 4.0, threads.ISO(d=3.0, p=0.5))
    assert auto_relax(bld.union(plain, screw)) == 0.6


def _pump_mouse(canvas, name, x, y, button=1, step=0):
    """Dispatch a synthetic matplotlib event through the canvas callback
    registry — the same path a real window takes."""
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    if name == "key_press_event":
        ev = KeyEvent(name, canvas, "r", x=x, y=y)
    else:
        ev = MouseEvent(name, canvas, x, y, button=button, step=step)
    canvas.callbacks.process(name, ev)


def test_show_wiring_event_pump():
    """Drives show()'s figure wiring on the Agg canvas: synthetic
    press/move/release/scroll/key events orbit the camera, render
    drag-quality frames while moving and full-quality at rest, and update
    the image artist."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    v = _viewer()
    fig = v._build_figure()
    canvas = fig.canvas
    assert v._frame_ms["full"]  # initial frame rendered at full quality
    n_full0, n_drag0 = len(v._frame_ms["full"]), len(v._frame_ms["drag"])
    img0 = np.asarray(v._im.get_array())
    yaw0 = v.yaw

    w, h = canvas.get_width_height()
    _pump_mouse(canvas, "button_press_event", w // 2, h // 2)
    assert v._dragging
    _pump_mouse(canvas, "motion_notify_event", w // 2 + 15, h // 2 + 5)
    assert v.yaw != yaw0  # orbit applied
    assert len(v._frame_ms["drag"]) == n_drag0 + 1  # motion = drag quality
    _pump_mouse(canvas, "button_release_event", w // 2 + 15, h // 2 + 5)
    assert not v._dragging
    assert len(v._frame_ms["full"]) == n_full0 + 1  # rest = full quality
    assert not np.array_equal(np.asarray(v._im.get_array()), img0)

    d0 = v.cam_dist
    _pump_mouse(canvas, "scroll_event", w // 2, h // 2, step=2)
    assert v.cam_dist < d0
    v.yaw = 9.9
    _pump_mouse(canvas, "key_press_event", w // 2, h // 2)
    assert v.yaw == 0.6

    stats = v.frame_stats()
    assert stats["full"]["frames"] >= 3 and stats["drag"]["frames"] >= 2
    assert stats["full"]["median_ms"] > 0 and stats["drag"]["fps"] > 0
    plt.close(fig)


def test_interactive_view_headless_writes_turntable(tmp_path, monkeypatch):
    """With no display, interactive_view writes the turntable GIF (on the
    viewer's device) instead of opening a window."""
    from gsdf_tpu_torch.pipeline import interactive

    monkeypatch.setattr(interactive, "has_display", lambda: False)
    monkeypatch.chdir(tmp_path)
    v = interactive.interactive_view(_obj(Builder()), width=16, height=12, device=CPU)
    assert v.device.type == "cpu"
    from PIL import Image

    with Image.open(tmp_path / "turntable.gif") as gif:
        assert gif.size == (16, 12) and gif.n_frames > 1


def test_interactive_view_raises_viewer_errors(tmp_path, monkeypatch):
    """Where a display exists, an error from the viewer itself (a failed
    build or launch) reaches the caller; nothing turns to the GIF."""
    from gsdf_tpu_torch.pipeline import interactive

    def broken(self):
        raise RuntimeError("raymarch kernel launch failed")

    monkeypatch.setattr(interactive, "has_display", lambda: True)
    monkeypatch.setattr(interactive.InteractiveViewer, "show", broken)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="launch failed"):
        interactive.interactive_view(_obj(Builder()), width=16, height=12, device=CPU)
    assert not (tmp_path / "turntable.gif").exists()


def test_pipelined_drag_frames_one_behind():
    """Drag pipelining: the displayed frame is one event behind the view
    state; a rest (full) frame flushes the pipeline and shows the exact
    current view."""
    obj = Builder().new_sphere(0.7)
    v = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16, pipeline=True,
                          device=CPU)
    assert v.pipeline
    v.on_press(10, 10)
    v.on_move(20, 10)
    f1 = v.render_current("drag")  # launches view A, shows view A
    v.on_move(52, 10)
    f2 = v.render_current("drag")  # launches view B, shows view A
    np.testing.assert_array_equal(f1, f2)  # one behind
    v.on_move(60, 30)
    f3 = v.render_current("drag")  # shows view B
    assert not np.array_equal(f2, f3)
    v.on_release()
    full = v.render_current("full")  # flush: exact current view
    assert v._pending is None
    v2 = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16, pipeline=False,
                           device=CPU)
    v2.yaw, v2.pitch, v2.cam_dist = v.yaw, v.pitch, v.cam_dist
    np.testing.assert_array_equal(full, v2.render_current("full"))


def _boss_part():
    bld = Builder()
    boss = bld.new_cylinder(0.45, 1.2, 0.05)
    return bld.smooth_union(0.1, bld.new_box(1.6, 1.0, 0.5, 0.05), boss), boss


def test_parametric_slider_edit_zero_recompile():
    """set_param (the slider callback) rebinds a continuous parameter and
    re-renders through the same per-structure library: nothing is built or
    loaded across edits, drag frames included."""
    obj, boss = _boss_part()
    v = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16,
                          params=[("boss r", boss, "r", 0.2, 0.6)], device=CPU)
    assert v.parametric
    img0 = v.render_current("full")
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    for r in (0.3, 0.55, 0.4):
        v.set_param(boss, "r", r)
        img = v.render_current("full")
    assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs
    assert not np.array_equal(img0, img)  # the edit is visible
    assert boss.r == np.float32(0.4)
    v.on_press(5, 5)
    v.on_move(25, 9)
    v.render_current("drag")
    v.render_current("drag")
    assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs


def test_set_param_requires_parametric_viewer():
    """set_param on a viewer constructed WITHOUT params raises: each rebind
    would build a fresh raymarch library per edit instead of the promised
    zero-recompile path."""
    obj, boss = _boss_part()
    v = InteractiveViewer(obj, width=32, height=32, steps=16, device=CPU)
    assert not v.parametric
    with pytest.raises(ValueError, match="params"):
        v.set_param(boss, "r", 0.3)


def test_viewer_frames_match_jax():
    """The same drag and rest frames as the JAX package's viewer after the
    same events (a 32 x 32 window: 16 x 16 drag frames, 96 x 96 rest
    supersamples), within one level."""
    jt = _obj(JaxBuilder())
    kw = dict(width=32, height=32, steps=48, drag_steps=16)
    port = InteractiveViewer(from_reference_tree(jt), device=CPU, **kw)
    with jax.disable_jit():
        ref = JaxViewer(jt, device=jax.devices("cpu")[0], **kw)
        frames = []
        for v in (ref, port):
            v.on_press(5, 5)
            v.on_move(12, 9)
            drag = v.render_current("drag")
            v.on_release()
            v.on_scroll(1)
            frames.append((drag, v.render_current("full")))
    for got, want in zip(frames[1], frames[0]):
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
