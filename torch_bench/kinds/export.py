"""`export`: SDF->STL into memory, `FlatRenderer(part, diagonal / resdiv)
.render_compact()` and `write_binary_stl_indexed` into a sink that keeps
the bytes it is given. The check holds every export's triangle count and
a sample's mesh and STL bytes to the reference's marching cubes."""
from __future__ import annotations

import numpy as np
import torch

from torch_bench.kinds import Request, program_attr
from torch_bench.kinds._mesh import STL_RECORD, Chunks, render_bound_s, soup_answer, soup_gap
from torch_bench.reference import mc

_f32 = np.float32
#: normals are compared where the reference triangle's area is at least this
#: share of a cube face (a sliver's normal turns on the last bits of its
#: vertices)
NORMAL_MIN_AREA = 1e-3


class Kind(Request):
    control_requests = 1

    def __init__(self, cell, part, device, fault=None):
        super().__init__(cell, part, device, fault)
        self.FlatRenderer = program_attr("gsdf_tpu_torch.render.flat.FlatRenderer")
        self.write_stl = program_attr("gsdf_tpu_torch.render.stl.write_binary_stl_indexed")
        self.res = part.bounds().diagonal() / int(self.config["resdiv"])

    def warm(self, spans):
        for _ in range(2):
            self.issue({}, spans)

    def issue(self, params, spans):
        with spans("render"):
            verts, tri_idx = self.FlatRenderer(self.part, self.res, self.device).render_compact()
        if self.fault == "half":
            tri_idx = tri_idx[: len(tri_idx) // 2]
        elif self.fault == "alter":
            verts = verts.copy()
            verts[len(verts) // 2] += _f32(0.5 * self.res)
        stl = Chunks()
        with spans("stl"):
            self.write_stl(stl, verts, tri_idx)
        return {"verts": verts, "tri_idx": tri_idx, "stl": stl}

    def summary(self, answer):
        return len(answer["tri_idx"]), answer["stl"].nbytes()

    def bound_s(self, completed):
        return render_bound_s(self.config, self.work, completed)

    def control_answer(self, params, ref_part, device, dtype):
        _, m = mc.reference_mesh(ref_part, ref_part.bounds(), int(self.config["resdiv"]),
                                 device, dtype)
        return soup_answer(m.tris.cpu().numpy())

    def check(self, samples, ref_part, device, dtype=torch.float32) -> dict:
        g, m = mc.reference_mesh(ref_part, ref_part.bounds(), int(self.config["resdiv"]),
                                 device, dtype)
        T = len(m.tris)
        self.work = {"active": m.active, "n_t": m.crossings}
        off = max((max(abs(t - T), abs(n - (84 + 50 * T))) for t, n in self.summaries), default=0)
        vert = normal = 0.0
        ref = m.tris.double()
        e1, e2 = ref[:, 1] - ref[:, 0], ref[:, 2] - ref[:, 0]
        cross = torch.linalg.cross(e1, e2)
        area = torch.linalg.norm(cross, dim=1)
        big = area >= NORMAL_MIN_AREA * float(g.res) ** 2
        n_ref = (cross / area.clamp(min=1e-300)[:, None])[big].cpu().numpy()
        for a in samples:
            stl = np.frombuffer(a["stl"].getvalue(), np.uint8)
            count = int(stl[80:84].view("<u4")[0]) if len(stl) >= 84 else -1
            rec = stl[84:].view(STL_RECORD) if (len(stl) - 84) % 50 == 0 else None
            if rec is None:
                rec = np.zeros(0, STL_RECORD)
            off = max(off, abs(count - T), abs(len(rec) - T), abs(len(a["tri_idx"]) - T))
            vert = max(vert, soup_gap(a["verts"][a["tri_idx"]], m.tris, g.res),
                       soup_gap(rec["v"], m.tris, g.res))
            n = min(len(rec), T)
            keep = big[:n].cpu().numpy()
            if keep.any():
                gap = np.abs(rec["normal"][:n][keep] - n_ref[: int(keep.sum())]).max()
                normal = max(normal, float(gap))
        return {"tris_off": off, "vert_gap": vert, "normal_gap": normal}
