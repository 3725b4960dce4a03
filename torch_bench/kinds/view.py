"""`view`: the viewer's rest frame. The view is set by a drag (`on_press`,
`on_move`, `on_release`) to the generator's yaw and pitch, then
`InteractiveViewer.render_current("full")` up to the fetched image; its
latency is the frame's own span. The check holds a sample of the frames
to the reference's sphere tracer at the same view."""
from __future__ import annotations

import importlib
import math
import sys

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
        """The bound of the window's sphere tracing, from the work K8's lanes
        ran in its frames (`frames_work`, after the window)."""
        work = frames_work(self.part, self.frames[mark[1]:], self.w, self.h, self.steps,
                           self.aa, self.cam_dist, self.device, int(self.config["ops_per_point"]))
        print(f"work of {work['frames']} frames: {work['evaluations']} evaluations, "
              f"{work['counted']} ops counted, {work['run']} ops run, skipped share "
              f"{1 - work['run'] / work['counted'] if work['counted'] else 0.0!r}",
              file=sys.stderr, flush=True)
        nbytes = work["frames"] * bounds.kernel_bytes("raymarch", pixels=self.w * self.h)
        self._bound = bounds.bound_s(work["run"], nbytes)

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


def function_ops(part, names) -> dict:
    """Each named function of the part's baked source -> its operations a
    point: `bounds.ops_per_point` on the program's plain node of that
    function, at seeded points in the part's box. The names are found by
    emitting each node of the part with the program's code generator."""
    cg = program_attr("gsdf_tpu_torch.codegen.cuda.Codegen")()
    cg.emit(part)
    nodes, seen, stack = {}, set(), [part]
    while stack:
        node = stack.pop()
        if id(node) not in seen:
            seen.add(id(node))
            nodes.setdefault(cg.emit(node), node)
            stack.extend(node.children())
    bb = part.bounds()
    return {n: bounds.ops_per_point(nodes[n], (bb.min, bb.max)) for n in set(names)}


def frames_work(part, views, w, h, steps, aa, cam_dist, device, ops_pp) -> dict:
    """The work of K8's frames of `part` at `views` ((yaw, pitch) each),
    taken again by K8's counting form (`count_short_circuits`): the frames,
    their evaluations, the operations `counted` at `ops_pp` an evaluation
    with the march's and rays' own (`bounds.raymarch_ops`), and those `run`:
    the counted less what the lanes skipped at each short-circuit site and
    loop, summed over the frames (`bounds.work_run`). On a tree with neither,
    K8 itself runs and nothing is skipped."""
    rk = importlib.import_module("gsdf_tpu_torch.eval.ray_kernels")
    vr = importlib.import_module("gsdf_tpu_torch.visual.raymarch")
    step_ops, ray_ops = view_arithmetic()
    relax = vr.auto_relax(part)
    rays = w * h * aa * aa
    shorts = bool(rk.sites(part) or rk.loops(part))
    rk.SHORT_CIRCUITS.clear()
    evaluations = counted = 0
    for yaw, pitch in views:
        cam = vr.camera(part, yaw, pitch, cam_dist)
        if shorts:
            _, evals = rk.count_short_circuits(part, cam, w, h, steps, relax, aa, device)
        else:
            _, evals = rk.raymarch(part, cam, w, h, steps, relax, aa, device, evals=True)
        n = int(evals.sum())
        evaluations += n
        counted += bounds.raymarch_ops(n, rays, ops_pp, step_ops, ray_ops)
    counts = dict(rk.SHORT_CIRCUITS)
    fn_ops = function_ops(part, map(bounds.skipped_function, counts.values()))
    return {"frames": len(views), "evaluations": evaluations, "counted": counted,
            "run": bounds.work_run(counted, counts, fn_ops)}


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
