"""`edit`: a slider step on the part pinned to its bounds, `rebind` of one
continuous dimension (one of the configuration's `edits`, to a value in
its range) and `render_compact(parametric=True)` up to the host mesh. The
check holds a sample of the meshes to the reference's mesh of the part
with the same dimensions, in the same pinned region."""
from __future__ import annotations

import numpy as np
import torch

from torch_bench.kinds import Request, program_attr
from torch_bench.kinds._mesh import node, render_bound_s, soup_answer, soup_gap
from torch_bench.reference import mc, sdf

_f32 = np.float32


class Kind(Request):
    sample_size = 8
    program_state = ("fr", "pinned", "nodes")

    def __init__(self, cell, part, device, fault=None):
        super().__init__(cell, part, device, fault)
        with_bounds = program_attr("gsdf_tpu_torch.core.wrappers.with_bounds")
        FlatRenderer = program_attr("gsdf_tpu_torch.render.flat.FlatRenderer")
        self.box = part.bounds()
        self.pinned = with_bounds(part, self.box)
        self.fr = FlatRenderer(self.pinned, self.box.diagonal() / int(self.config["resdiv"]),
                               device)
        self.edits = {e["name"]: e for e in self.config["edits"]}
        self.nodes = {n: node(part, e["node"]) for n, e in self.edits.items()}
        self.values = dict(cell.reference.ORIGINAL)

    def value(self, name, u):
        """The value edit `name` sets at u in [0, 1] of its range, from the
        published dimension."""
        e = self.edits[name]
        lo, hi = e["range"]
        x = _f32(lo + (hi - lo) * u)
        orig = _f32(self.cell.reference.ORIGINAL[name])
        return _f32(orig * x) if e["by"] == "scale" else _f32(orig + x)

    def _set(self, name, value):
        e = self.edits[name]
        v = value
        if "vector" in e:
            v = np.array([value if x is None else x for x in e["vector"]], _f32)
        self.pinned.rebind({self.nodes[name]: {e["param"]: v}})

    def warm(self, spans):
        self.fr.render_compact(parametric=True)
        first = self.config["edits"][0]["name"]
        self.issue({"edit": {"name": first}, "u": None}, spans)

    def issue(self, params, spans):
        name = params["edit"]["name"]
        value = self.values[name] if params["u"] is None else self.value(name, params["u"])
        self.values[name] = value
        with spans("rebind"):
            if self.fault != "stale":
                self._set(name, value)
        with spans("render"):
            verts, tri_idx = self.fr.render_compact(parametric=True)
        if self.fault == "half":
            tri_idx = tri_idx[: len(tri_idx) // 2]
        return {"values": dict(self.values), "verts": verts, "tri_idx": tri_idx}

    def bound_s(self, completed):
        return render_bound_s(self.config, self.work, completed,
                              int(self.config["continuous_parameters"]))

    def check(self, samples, ref_part, device, dtype=torch.float32) -> dict:
        off, vert, active, n_t = 0, 0.0, [], []
        box = ref_part.bounds()  # the region: the published part's bounds
        for a in samples:
            part = sdf.Pinned(self.cell.reference.part(a["values"]), box)
            g, m = mc.reference_mesh(part, box, int(self.config["resdiv"]), device, dtype)
            active.append(m.active)
            n_t.append(m.crossings)
            off = max(off, abs(len(a["tri_idx"]) - len(m.tris)))
            vert = max(vert, soup_gap(a["verts"][a["tri_idx"]], m.tris, g.res))
        if active:
            self.work = {"active": float(np.mean(active)), "n_t": float(np.mean(n_t))}
        return {"tris_off": off, "vert_gap": vert}

    def control_sample(self, params, state):
        values = state.setdefault("values", dict(self.cell.reference.ORIGINAL))
        name = params["edit"]["name"]
        values[name] = self.value(name, params["u"])
        return dict(values)

    def control_answer(self, values, ref_part, device, dtype):
        box = ref_part.bounds()
        part = sdf.Pinned(self.cell.reference.part(values), box)
        _, m = mc.reference_mesh(part, box, int(self.config["resdiv"]), device, dtype)
        return {"values": dict(values), **soup_answer(m.tris.cpu().numpy())}

    def control_extra(self, kept, baked):
        """`builds` of edits rendered without the parametric path (a baked
        library per edited tree: an nvcc run and a load each)."""
        if not baked or "builds" not in self.cell.limits:
            return {}
        counts = program_attr("gsdf_tpu_torch._build.COUNTS")
        before = sum(counts.values())
        for values in kept[:1]:
            for name, v in values.items():
                self._set(name, v)
            self.fr.render_compact()
        return {"builds": sum(counts.values()) - before}
