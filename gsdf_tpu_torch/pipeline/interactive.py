"""Interactive raymarch viewer — the counterpart of the reference's GLFW
orbit/zoom UI (gsdfaux/ui.go:17-245); torch counterpart of
gsdf_tpu/pipeline/interactive.py.

The reference raymarches in a fragment shader and downgrades antialiasing
while the mouse moves (AA=1 during motion, 3 at rest, ui.go:131-241).
Here frames come from the raymarcher on the card (visual/raymarch.py,
K8); the same motion-adaptive trick renders DRAG frames at half
resolution / fewer steps and re-renders one full-quality frame at rest.
Frame size, steps and aa are K8's launch arguments, so drag and rest
frames share one library and nothing is built after the first frame. The
event loop is matplotlib's — no GL/windowing dependency beyond what the
host already has; with no display (agg backend) callers fall back to the
headless turntable.

Controls (matching ui.go's bindings):
  left-drag   orbit (yaw/pitch)
  scroll      zoom (camera distance)
  r           reset view
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from ..core.node import Shader3D
from ..kernels import entry_device


def has_display() -> bool:
    """True when matplotlib can open an interactive window."""
    try:
        import matplotlib
    except Exception:
        return False
    backend = matplotlib.get_backend().lower()
    if "agg" in backend and "webagg" not in backend:
        # try to switch to an interactive backend
        for cand in ("TkAgg", "QtAgg", "GTK4Agg", "MacOSX"):
            try:
                matplotlib.use(cand, force=True)
                return True
            except Exception:
                continue
        return False
    return True


def _start_fetch(frame: torch.Tensor):
    """Enqueue frame's copy to the host: (pinned host tensor, event that
    marks the copy done) for a frame on the card, (frame, None) for one on
    the CPU."""
    if frame.device.type != "cuda":
        return frame, None
    host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
    host.copy_(frame, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(frame.device))
    return host, done


class InteractiveViewer:
    """Orbit/zoom viewer state machine; testable without a window via
    `render_current` + the `on_*` handlers."""

    def __init__(
        self,
        obj: Shader3D,
        width: int = 512,
        height: int = 512,
        device=None,
        steps: int = 196,
        drag_steps: int = 72,
        aa: int = 3,
        verbose: bool = False,
        pipeline: bool = False,
        params=None,
    ):
        self.obj = obj
        self.width = int(width)
        self.height = int(height)
        self.device = entry_device(device)
        self.steps = int(steps)
        self.drag_steps = int(drag_steps)
        #: rest-quality supersampling; drag frames always render aa=1.
        #: Default 3 matches the reference UI's AA=3-at-rest / 1-in-
        #: motion behavior (gsdfaux/ui.go:131-241); the aa*W x aa*H
        #: frame is box-filtered on the card so the fetched payload stays
        #: W x H regardless.
        self.aa = int(aa)
        #: per-frame wall latency log, keyed 'drag'/'full' — the viewer's
        #: observability (frame_stats; the card's numbers in PERF.md)
        self._frame_ms: dict = {"drag": [], "full": []}
        self.verbose = bool(verbose)
        #: drag-frame pipelining: frame N-1's copy to pinned host memory
        #: is enqueued before frame N launches, on the same stream, so the
        #: fetch of N-1 waits only for N-1 and overlaps N's march; the
        #: displayed frame then lags the view by one mouse event
        self.pipeline = bool(pipeline)
        self._pending = None  # the last drag frame on the device, unfetched
        #: parametric slider bindings: [(label, node, param, lo, hi)];
        #: when set, renders route through the per-STRUCTURE library (K8p)
        #: so slider edits never build
        self.params = list(params) if params else []
        self.parametric = bool(self.params)
        self.reset()
        self._dragging = False
        self._last_xy = None

    def reset(self):
        self.yaw = 0.6
        self.pitch = 0.5
        self.cam_dist = 2.4

    # --- rendering ----------------------------------------------------
    def _dispatch(self, quality: str) -> torch.Tensor:
        """Launch the current view's frame; returns the DEVICE tensor
        (unfetched)."""
        from ..visual.raymarch import raymarch_image_device

        if quality == "drag":
            w, h, steps, aa = (
                self.width // 2,
                self.height // 2,
                self.drag_steps,
                1,
            )
        else:
            w, h, steps, aa = self.width, self.height, self.steps, self.aa
        return raymarch_image_device(
            self.obj,
            width=w,
            height=h,
            yaw=self.yaw,
            pitch=self.pitch,
            cam_dist=self.cam_dist,
            steps=steps,
            device=self.device,
            aa=aa,
            parametric=self.parametric,
        )

    def render_current(self, quality: str = "full") -> np.ndarray:
        """Render the current view. quality='drag' uses half resolution
        and fewer steps (motion-adaptive, reference ui.go:131-241), and
        when pipelining is on, overlaps this frame's march with the
        previous drag frame's fetch (the returned image is then one
        event behind the view state)."""
        t0 = time.monotonic()
        if quality == "drag" and self.pipeline:
            prev = None if self._pending is None else _start_fetch(self._pending)
            dev = self._dispatch("drag")  # frame N, behind N-1's copy
            self._pending = dev
            if prev is None:  # nothing in flight yet: show frame N
                img = dev.cpu().numpy()
            else:  # wait for N-1's copy only
                host, done = prev
                if done is not None:
                    done.synchronize()
                img = host.numpy()
        else:
            self._pending = None  # rest frame: flush the pipeline
            img = self._dispatch(quality).cpu().numpy()
        if quality == "drag":
            img = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
        dt = (time.monotonic() - t0) * 1e3
        key = "drag" if quality == "drag" else "full"
        self._frame_ms[key].append(dt)
        if self.verbose:
            print(f"[{dt:.1f}ms] {key} frame")
        return img

    def frame_stats(self) -> dict:
        """Per-quality frame latency: {'drag': {'frames', 'median_ms',
        'fps'}, 'full': {...}} — entries only for qualities rendered.
        (The first frame of each quality includes the library's build or
        load; median is the steady-state number.)"""
        out = {}
        for q, ts in self._frame_ms.items():
            if ts:
                med = statistics.median(ts)
                out[q] = {
                    "frames": len(ts),
                    "median_ms": med,
                    "fps": 1e3 / med if med > 0 else float("inf"),
                }
        return out

    # --- event handlers (wired to matplotlib, callable directly) -------
    def on_press(self, x, y):
        self._dragging = True
        self._last_xy = (x, y)

    def on_release(self):
        self._dragging = False
        self._last_xy = None

    def on_move(self, x, y) -> bool:
        """Returns True when the view changed (drag orbit)."""
        if not self._dragging or self._last_xy is None:
            return False
        dx = x - self._last_xy[0]
        dy = y - self._last_xy[1]
        self._last_xy = (x, y)
        # same sensitivity scale as the reference orbit (ui.go:205-214)
        self.yaw -= dx * 2 * math.pi / self.width
        self.pitch = min(
            max(self.pitch + dy * math.pi / self.height, -1.45), 1.45
        )
        return True

    def on_scroll(self, step) -> bool:
        self.cam_dist = float(np.clip(self.cam_dist * 0.9**step, 1.2, 8.0))
        return True

    def set_param(self, node, name, value) -> None:
        """Parametric slider edit: rebind one continuous parameter and
        re-render through the SAME per-structure library (K8p) — no build
        per edit (eval.parametric).

        Only valid on a viewer constructed with `params`: without the
        parametric library, every rebind would change the tree hash and
        build a fresh raymarch library per edit — seconds per slider tick
        and unbounded library growth."""
        if not self.parametric:
            raise ValueError(
                "set_param requires a viewer constructed with params=[...] "
                "(the zero-recompile parametric executable); rebinding a "
                "non-parametric viewer would recompile on every edit"
            )
        self.obj.rebind({node: {name: float(value)}})
        self._pending = None  # view changed shape: flush stale frames

    # --- event loop ----------------------------------------------------
    def _build_figure(self):
        """Create the figure and wire the event handlers. Backend-agnostic
        (works on Agg — the event-pump tests drive exactly this wiring);
        `show()` adds the display gate and blocks on the loop."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 7))
        try:
            fig.canvas.manager.set_window_title("gsdf_tpu_torch viewer")
        except Exception:
            pass  # headless managers may lack a window title
        ax.set_axis_off()
        im = ax.imshow(self.render_current("full"))
        self._im = im

        def redraw(quality):
            im.set_data(self.render_current(quality))
            fig.canvas.draw_idle()

        def press(ev):
            if ev.xdata is not None:
                self.on_press(ev.x, ev.y)

        def release(ev):
            self.on_release()
            redraw("full")  # rest: full quality (reference AA upshift)

        def move(ev):
            if self.on_move(ev.x, ev.y):
                redraw("drag")

        def scroll(ev):
            if self.on_scroll(ev.step):
                redraw("drag")
                redraw("full")

        def key(ev):
            if ev.key == "r":
                self.reset()
                redraw("full")

        fig.canvas.mpl_connect("button_press_event", press)
        fig.canvas.mpl_connect("button_release_event", release)
        fig.canvas.mpl_connect("motion_notify_event", move)
        fig.canvas.mpl_connect("scroll_event", scroll)
        fig.canvas.mpl_connect("key_press_event", key)

        # parametric sliders: one per (label, node, param, lo, hi)
        if self.params:
            from matplotlib.widgets import Slider

            fig.subplots_adjust(bottom=0.10 + 0.05 * len(self.params))
            self._sliders = []
            for i, (label, node, pname, lo, hi) in enumerate(self.params):
                sax = fig.add_axes([0.25, 0.04 + 0.05 * i, 0.55, 0.03])
                sl = Slider(
                    sax, label, float(lo), float(hi),
                    valinit=float(getattr(node, pname)),
                )

                def _onchange(val, _n=node, _p=pname):
                    self.set_param(_n, _p, val)
                    redraw("full")

                sl.on_changed(_onchange)
                self._sliders.append(sl)
        return fig

    def show(self):
        """Open the matplotlib window and run the event loop. Raises
        RuntimeError when no interactive backend exists (callers fall
        back to the headless turntable)."""
        if not has_display():
            raise RuntimeError(
                "no interactive matplotlib backend (headless host); "
                "use pipeline.ui() for a turntable GIF instead"
            )
        import matplotlib.pyplot as plt

        self._build_figure()
        plt.show()
        if self.verbose:
            for q, s in self.frame_stats().items():
                print(
                    f"[viewer] {q}: {s['frames']} frames, "
                    f"median {s['median_ms']:.1f}ms ({s['fps']:.1f} fps)"
                )


def interactive_view(obj: Shader3D, width=512, height=512, device=None):
    """Open the interactive orbit/zoom viewer (reference gsdfaux.UI).
    Falls back to a turntable GIF on display-less hosts; the GIF still
    renders on the viewer's device. Only a missing display turns to the
    GIF: an error from the viewer itself (a build or a launch) is raised."""
    viewer = InteractiveViewer(obj, width=width, height=height, device=device)
    if has_display():
        viewer.show()
        return viewer
    from .render import UIConfig, ui

    print("[viewer] no interactive matplotlib backend (headless host); "
          "writing a turntable GIF instead")
    ui(obj, UIConfig(width=width, height=height, gif_path="turntable.gif",
                     device=viewer.device))
    return viewer
