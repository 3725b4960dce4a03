"""The port's spans (gsdf_tpu_torch/spans.py) on the CPU: off records nothing
and opens no profiler range; `recording()` and a running torch.profiler
switch them on; the viewer frame's and the mesh path's spans nest as the
code does, with one request id; a profiler trace holds them as `gsdf.*`
ranges nested as in memory; the ring keeps its bound; the viewer's
`frame_stats` keeps its shape; `kernels.launch` opens `launch.<kernel>`
around its C entry call (a stub entry: no card here); and one
`Library.launch` serves both forms of a library, a parametric one packing
its vector in `params.pack` first (a stub library)."""
import contextlib
import io
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsdf_tpu_torch import Builder, kernels, spans
from gsdf_tpu_torch.codegen.params import kernel_params
from gsdf_tpu_torch.pipeline import InteractiveViewer
from gsdf_tpu_torch.render.flat import FlatRenderer
from gsdf_tpu_torch.render.stl import write_binary_stl_indexed

CPU = "cpu"


@pytest.fixture(autouse=True)
def _empty_store():
    spans.clear()
    yield
    spans.clear()


def _obj():
    b = Builder()
    return b.smooth_union(0.1, b.new_sphere(0.7), b.new_box(1, 1, 0.4, 0))


def _viewer(**kw):
    return InteractiveViewer(_obj(), width=24, height=20, steps=32, drag_steps=12, device=CPU,
                             **kw)


def _renderer():
    obj = _obj()
    return FlatRenderer(obj, obj.bounds().diagonal() / 24, CPU)


def _names(recs):
    return sorted(r.name for r in recs)


def _raise(*a, **k):
    raise AssertionError("a profiler range was opened with tracing off")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    img = _viewer().render_current("full")
    verts, tri_idx = _renderer().render_compact()
    write_binary_stl_indexed(io.BytesIO(), verts, tri_idx)
    assert img.shape == (20, 24, 3) and len(tri_idx) > 0
    assert spans.records() == []
    assert spans.span("x") is spans.span("y")  # the one shared null context


def test_viewer_frame_spans_nest_under_one_request(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)  # no profiler: no range
    v = _viewer()
    with spans.recording():
        v.render_current("full")
    recs = spans.records()
    assert _names(recs) == ["raymarch.scene", "viewer.fetch", "viewer.frame"]
    root = next(r for r in recs if r.name == "viewer.frame")
    assert root.parent is None and root.request == root.seq
    for r in recs:
        assert r.request == root.request
        assert r.start <= r.end
        if r is not root:
            assert r.parent == root.seq
            assert root.start <= r.start and r.end <= root.end
    s = spans.summary()
    assert s["viewer.frame"]["count"] == 1
    for name, row in s.items():
        assert 0 <= row["self_s"] <= row["total_s"]
    children = s["raymarch.scene"]["total_s"] + s["viewer.fetch"]["total_s"]
    assert s["viewer.frame"]["self_s"] == pytest.approx(s["viewer.frame"]["total_s"] - children)


def test_each_frame_is_its_own_request_and_drag_fetch_is_spanned():
    v = _viewer(pipeline=True)
    with spans.recording():
        v.render_current("full")
        v.render_current("drag")
        v.render_current("drag")  # behind the first drag frame's copy
    recs = spans.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["viewer.frame"] * 3
    assert len({r.request for r in roots}) == 3
    for root in roots:
        mine = _names(r for r in recs if r.request == root.request)
        assert mine == ["raymarch.scene", "viewer.fetch", "viewer.frame"]


def test_profiler_shows_the_spans_as_nested_gsdf_ranges(tmp_path):
    v = _viewer()
    v.render_current("full")  # warm: the spans of a frame outside the session are not kept
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v.render_current("full")
    recs = spans.records()  # recorded without recording()
    assert _names(recs) == ["raymarch.scene", "viewer.fetch", "viewer.frame"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("gsdf.")]
    assert all(e["cat"] == "user_annotation" for e in events)
    by_name = {e["name"][5:]: e for e in events}
    assert sorted(by_name) == _names(recs)
    for r in recs:
        if r.parent is None:
            continue
        parent = next(p for p in recs if p.seq == r.parent)
        e, pe = by_name[r.name], by_name[parent.name]
        assert pe["ts"] <= e["ts"] and e["ts"] + e["dur"] <= pe["ts"] + pe["dur"]


def test_mesh_path_spans():
    fr = _renderer()
    with spans.recording():
        verts, tri_idx = fr.render_compact()
        write_binary_stl_indexed(io.BytesIO(), verts, tri_idx)
    recs = spans.records()
    root = next(r for r in recs if r.name == "flat.render_compact")
    under = _names(r for r in recs if r.parent == root.seq)
    # on the CPU the compact path runs K3's plain version: no count read
    assert under == ["compact.fetch", "native.decode"]
    stl = next(r for r in recs if r.name == "stl.encode")
    assert stl.parent is None and stl.request != root.request


def test_params_pack_span():
    class Lib:
        by_value = True

    with spans.recording():
        ptr, n, keep = kernels.param_args(_obj(), Lib(), CPU)
    assert n == len(keep) and ptr == keep.ctypes.data
    assert _names(spans.records()) == ["params.pack"]


def test_one_launch_call_serves_both_forms(monkeypatch):
    """`Library.launch` on a stub library of K8 on a stand-in card: the
    parametric form's C entry receives (..., pointer, length, stream) from
    one call, which counts under raymarch_param inside
    `launch.raymarch_param`, after `params.pack`; the parameter arguments
    it returns pass the same vector to a second call, which packs nothing;
    the baked form's entry receives the stream alone after its arguments."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 77, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setitem(kernels.LAUNCHES, "raymarch", 0)
    monkeypatch.setitem(kernels.LAUNCHES, "raymarch_param", 0)
    called = []

    def entry(*args):
        called.append((args, [s.name for s in getattr(spans._local, "open", [])]))
        return 0

    class CDLL:
        gsdf_raymarch = gsdf_raymarch_param = staticmethod(entry)

        @staticmethod
        def gsdf_params_by_value():
            return 1

    card, tree = torch.device("cuda", 0), _obj()
    lib = kernels.Library(CDLL(), ("raymarch.cu",), parametric=True)
    with spans.recording():
        params = lib.launch("raymarch", card, 1, 2, tree=tree)
    ptr, n, keep = params
    assert n == len(kernel_params(tree)) == len(keep) and ptr == keep.ctypes.data
    assert called == [((1, 2, ptr, n, 77), ["launch.raymarch_param"])]
    pack, run = spans.records()
    assert (pack.name, run.name) == ("params.pack", "launch.raymarch_param")
    assert pack.parent is None and run.parent is None
    assert kernels.LAUNCHES["raymarch_param"] == 1 and kernels.LAUNCHES["raymarch"] == 0
    spans.clear()
    with spans.recording():
        assert lib.launch("raymarch", card, 3, tree=tree, params=params, count=False) is params
    assert called[-1][0] == (3, ptr, n, 77)
    assert _names(spans.records()) == ["launch.raymarch_param"]
    assert kernels.LAUNCHES["raymarch_param"] == 1
    baked = kernels.Library(CDLL(), ("raymarch.cu",))
    assert baked.launch("raymarch", card, 4, tree=tree) is None
    assert called[-1][0] == (4, 77) and kernels.LAUNCHES["raymarch"] == 1


def test_launch_span_around_the_c_entry(monkeypatch):
    """`kernels.launch` with a stub C entry on a stand-in card: the span
    covers the entry call, the launch count moves by one either way."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 77, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setitem(kernels.LAUNCHES, "raymarch", 0)
    called = []

    def entry(*args):
        called.append((args, [s.name for s in getattr(spans._local, "open", [])]))
        return 0

    card = torch.device("cuda", 0)
    kernels.launch("raymarch", card, entry, 1, 2)
    assert spans.records() == [] and kernels.LAUNCHES["raymarch"] == 1
    with spans.recording():
        kernels.launch("raymarch", card, entry, 3, 4)
    assert called == [((1, 2, 77), []), ((3, 4, 77), ["launch.raymarch"])]
    (rec,) = spans.records()
    assert rec.name == "launch.raymarch" and rec.parent is None
    assert kernels.LAUNCHES["raymarch"] == 2
    with spans.recording(), pytest.raises(RuntimeError, match="CUDA error 9"):
        kernels.launch("raymarch", card, lambda *a: 9)
    assert len(spans.records()) == 2 and kernels.LAUNCHES["raymarch"] == 2


def test_ring_keeps_the_newest():
    with spans.recording():
        for _ in range(spans.RING + 5):
            with spans.span("s"):
                pass
    recs = spans.records()
    assert len(recs) == spans.RING
    assert recs[0].seq + spans.RING - 1 == recs[-1].seq
    assert spans.summary()["s"]["count"] == spans.RING


def test_a_raising_block_closes_its_span():
    with spans.recording():
        with pytest.raises(ValueError), spans.span("outer"):
            with spans.span("inner"):
                raise ValueError
        with spans.span("after"):
            pass
    recs = {r.name: r for r in spans.records()}
    assert recs["inner"].parent == recs["outer"].seq
    assert recs["after"].parent is None


@pytest.mark.parametrize("traced", [False, True])
def test_frame_stats_keys_and_counts(traced):
    v = _viewer()
    with spans.recording() if traced else contextlib.nullcontext():
        v.render_current("full")
        v.render_current("drag")
        v.render_current("full")
    stats = v.frame_stats()
    assert sorted(stats) == ["drag", "full"]
    assert stats["full"]["frames"] == 2 and stats["drag"]["frames"] == 1
    for s in stats.values():
        assert sorted(s) == ["fps", "frames", "median_ms"]
        assert s["median_ms"] > 0 and s["fps"] == pytest.approx(1e3 / s["median_ms"])
    frames = [r for r in spans.records() if r.name == "viewer.frame"]
    assert len(frames) == (3 if traced else 0)
    if traced:  # the viewer's clock is the span's
        got = sorted(v._frame_ms["full"] + v._frame_ms["drag"])
        assert got == sorted((r.end - r.start) * 1e3 for r in frames)


def test_the_march_counter_counts_what_raymarch_returns():
    """`ray_kernels.MARCH` adds the frame, the rays and the evaluations that
    raymarch(..., evals=True) returned (K8's plain version on the CPU, on a
    small frame of the knurled cylinder); a frame without evals, the
    viewer's, leaves it as it was; `spans.summary()` still holds span rows
    alone."""
    from gsdf_tpu_torch import flagships
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.visual.raymarch import auto_relax, camera

    part = flagships.build_knurled()
    cam, relax = camera(part, 0.6, 0.5, 2.4), auto_relax(part)
    before = dict(rk.MARCH)
    try:
        img, evals = rk.raymarch(part, cam, 16, 12, 48, relax, 2, CPU, evals=True)
        assert evals.shape == (24, 32) and int(evals.sum()) > 6 * evals.numel()
        counted = {"frames": before["frames"] + 1, "rays": before["rays"] + 24 * 32,
                   "evaluations": before["evaluations"] + int(evals.sum())}
        assert rk.MARCH == counted
        assert torch.equal(rk.raymarch(part, cam, 16, 12, 48, relax, 2, CPU), img)
        assert rk.MARCH == counted
        assert all(set(row) == {"count", "total_s", "self_s"} for row in spans.summary().values())
    finally:
        rk.MARCH.update(before)
