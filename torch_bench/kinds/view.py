"""`view`: the viewer's rest frame. The view is set by a drag (`on_press`,
`on_move`, `on_release`) to the generator's yaw and pitch, then
`InteractiveViewer.render_current("full")` up to the fetched image; its
latency is the frame's own span. The check holds a sample of the frames
to the reference's sphere tracer at the same view."""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from torch_bench import bounds
from torch_bench.kinds import Request, program_attr
from torch_bench.reference import raymarch as rref

_f32 = np.float32


class Kind(Request):
    latency_span = "frame"
    program_state = ("viewer",)

    def __init__(self, cell, part, device, fault=None):
        super().__init__(cell, part, device, fault)
        Viewer = program_attr("gsdf_tpu_torch.pipeline.interactive.InteractiveViewer")
        f = self.mix["frame"]
        self.w, self.h = int(f["width"]), int(f["height"])
        self.steps, self.aa = int(f["steps"]), int(f["aa"])
        self.viewer = Viewer(part, width=self.w, height=self.h, device=device, steps=self.steps,
                             aa=self.aa)
        start = self.mix["start"]
        self.yaw, self.pitch = float(start["yaw"]), float(start["pitch"])
        self.cam_dist = float(start["cam_dist"])
        self.frames: list = []  # (yaw, pitch) of every frame issued
        self._bound = None

    def warm(self, spans):
        self.issue({"yaw": self.yaw, "pitch": self.pitch}, spans)
        self.frames.clear()

    def _drag(self, yaw, pitch):
        """Drag the mouse from (0, 0) by what moves the view to (yaw, pitch),
        and track the view as the viewer's orbit rule moves it."""
        dx = -(yaw - self.yaw) * self.w / (2 * math.pi)
        dy = (pitch - self.pitch) * self.h / math.pi
        self.viewer.on_press(0.0, 0.0)
        self.viewer.on_move(dx, dy)
        self.viewer.on_release()
        self.yaw -= dx * 2 * math.pi / self.w
        self.pitch = min(max(self.pitch + dy * math.pi / self.h, -1.45), 1.45)

    def issue(self, params, spans):
        self._drag(params["yaw"], params["pitch"])
        with spans("frame"):
            img = self.viewer.render_current("full")
        view = (self.yaw, self.pitch)
        self.frames.append(view)
        if self.fault == "alter":
            view = (self.yaw + 0.05, self.pitch)
        elif self.fault == "half":
            img = img.copy()
            img[: self.h // 2] = 0
        return {"view": view, "img": img}

    def mark(self):
        return len(self.summaries), len(self.frames)

    def rewind(self, mark):
        del self.summaries[mark[0]:]
        del self.frames[mark[1]:]

    def count_work(self, mark):
        """The bound of the window's sphere tracing, from the evaluations
        each frame needs as K8 counts them (its `evals` output, taken again
        for each frame of the window after it)."""
        rk = importlib.import_module("gsdf_tpu_torch.eval.ray_kernels")
        vr = importlib.import_module("gsdf_tpu_torch.visual.raymarch")
        step_ops, ray_ops = view_arithmetic()
        relax = vr.auto_relax(self.part)
        ops_pp = int(self.config["ops_per_point"])
        rays = self.w * self.h * self.aa * self.aa
        total = 0.0
        for yaw, pitch in self.frames[mark[1]:]:
            cam = vr.camera(self.part, yaw, pitch, self.cam_dist)
            _, evals = rk.raymarch(self.part, cam, self.w, self.h, self.steps, relax, self.aa,
                                   self.device, evals=True)
            ops = bounds.raymarch_ops(int(evals.sum()), rays, ops_pp, step_ops, ray_ops)
            total += bounds.bound_s(ops, bounds.kernel_bytes("raymarch", pixels=self.w * self.h))
        self._bound = total

    def bound_s(self, completed):
        return self._bound

    def reference_frame(self, ref_part, view, device, dtype=torch.float32):
        cam = rref.camera(ref_part.bounds(), view[0], view[1], self.cam_dist)
        return rref.frame(ref_part, cam, self.w, self.h, self.steps,
                          rref.relaxation(ref_part), self.aa, device, dtype)

    def check(self, samples, ref_part, device, dtype=torch.float32) -> dict:
        share = 0.0
        for a in samples:
            img, _ = self.reference_frame(ref_part, a["view"], device, dtype)
            diff = np.abs(a["img"].astype(np.int16) - img.cpu().numpy().astype(np.int16))
            share = max(share, float((diff.max(axis=-1) > 1).mean()))
        return {"px_off_share": share}

    def control_sample(self, params, state):
        return params["yaw"], params["pitch"]

    def control_answer(self, view, ref_part, device, dtype):
        img, _ = self.reference_frame(ref_part, view, device, dtype)
        return {"view": view, "img": img.cpu().numpy()}


class _NoPart:
    """A stand-in part whose distance costs nothing: what a raymarched frame
    does besides the part."""

    @staticmethod
    def distance(p):
        return p[..., 0]


def view_arithmetic() -> tuple:
    """(a march step's own operations, a ray's direction and shading), each
    per ray, counted on the reference's pieces."""
    cam = rref.camera((np.full(3, -1, _f32), np.full(3, 1, _f32)), 0.0, 0.0, 2.0)
    c = rref._consts(cam, 0.8, "cpu")

    def along(n):
        return torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3), torch.full((n,), 0.5)

    f32 = torch.float32
    step = bounds.per_item(lambda n: rref._march_step(_NoPart, c, *along(n), f32), 64)
    ray = bounds.per_item(lambda n: rref._rays(c, n, 1, "cpu"), 64)
    shade = bounds.per_item(lambda n: rref._shade(_NoPart, c, *along(n), f32), 64)
    return step, ray + shade
