"""The port's compact SDF->STL path against the JAX package's (CPU).

`FlatRenderer.render_compact` of both packages renders the four golden
parts (flange, showerhead, ISO M3 bolt, knurled cylinder) at resdiv 60:
the compact payload's cube ids and case bytes must be equal, the triangle
count and connectivity (tri_idx) equal, and vertices within atol=1e-5.
The JAX package runs op by op (`jax.disable_jit`) so that XLA-CPU's FMA
contraction does not move its distances; what remains is the last ulp of
atan2, sin and cos and of torch's CPU sqrt at the parts' 25 mm scale.

The golden counts themselves (bolt resdiv 300 = 137,528, knurled
resdiv 350 = 616,324) are rendered through the port's plain torch path.

Also: K3's edge count and K4's offsets against the JAX payload, the
renderer's input checks, the numpy decoder against the native
one, and the STL bytes of both packages.
"""
import io

import jax
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.ops.compact_field import compact_field_render as jax_compact_field_render
from gsdf_tpu.render.flat import FlatRenderer as JaxFlatRenderer
from gsdf_tpu.render.stl import write_binary_stl_indexed as jax_write_stl
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch import cli
from gsdf_tpu_torch import flagships as torch_flagships
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.native import mc_decode, mc_decode_plain
from gsdf_tpu_torch.ops import mc_emit
from gsdf_tpu_torch.ops.compact_field import compact_field_render
from gsdf_tpu_torch.render.flat import FlatRenderer
from gsdf_tpu_torch.render.stl import write_binary_stl_indexed

RESDIV = 60
PARTS = ["flange", "showerhead", "bolt", "knurled"]
_cache = {}


def render_both(name):
    """(jax payload, jax mesh, port payload, port mesh, renderer) of a part."""
    if name not in _cache:
        jtree = getattr(jax_flagships, f"build_{name}")()
        ttree = getattr(torch_flagships, f"build_{name}")()
        res = jtree.bounds().diagonal() / RESDIV
        jfr = JaxFlatRenderer(jtree, res)
        tfr = FlatRenderer(ttree, res, torch.device("cpu"))
        shape = tfr.shape()
        assert shape == (jfr.nz + 1, jfr.ny + 1, jfr.nx + 1)
        with jax.disable_jit():
            jpay = jax_compact_field_render(
                jtree, jfr.origin, jfr.res, shape, jax.devices("cpu")[0]
            )[:3]
            jmesh = jfr.render_compact()
        tpay = compact_field_render(ttree, tfr.origin, tfr.res, shape, tfr.device)
        _cache[name] = (jpay, jmesh, tpay, tfr.render_compact(), tfr)
    return _cache[name]


@pytest.mark.parametrize("name", PARTS)
def test_compact_payload_matches_jax(name):
    (jids, jcases, jt), _, (ids, cases, t), _, _ = render_both(name)
    assert ids.dtype == np.uint32 and cases.dtype == np.uint8 and t.dtype == np.float32
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cases, jcases)
    assert len(t) == len(jt)
    assert len(ids) > 1000


@pytest.mark.parametrize("name", PARTS)
def test_compaction_edge_outputs_match_jax(name):
    """K3's plain version on the port's case grid: the crossing owner-edge
    count equals the length of the JAX package's compact t, and K4's
    offsets (the edges before every 256th active cube) equal the exclusive
    cumsum of the JAX payload's per-cube crossing counts."""
    (jids, jcases, jt), _, _, _, fr = render_both(name)
    _, cases = gk.classified_grid_plain(fr.s, fr.origin, fr.res, fr.shape(), fr.device)
    comp = mc_emit.compact_active_plain(cases)
    np.testing.assert_array_equal(comp.ids.numpy().view(np.uint32), jids)
    assert comp.n_t == len(jt) > 1000
    j = jcases.astype(np.int64)
    b0 = j & 1
    n_cross = (b0 != (j >> 1) & 1).astype(np.int64) + (b0 != (j >> 3) & 1) + (b0 != (j >> 4) & 1)
    before = np.cumsum(n_cross) - n_cross
    assert comp.offsets.dtype == torch.int64
    np.testing.assert_array_equal(comp.offsets.numpy(), before[::256])


@pytest.mark.parametrize("name", PARTS)
def test_render_compact_matches_jax(name):
    _, (jverts, jtri), _, (verts, tri), _ = render_both(name)
    assert len(tri) == len(jtri) > 1000
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "name, resdiv, golden",
    [
        ("bolt", 300, torch_flagships.GOLDEN_BOLT_TRIS),
        ("knurled", 350, torch_flagships.GOLDEN_KNURLED_TRIS),
    ],
)
def test_golden_count_on_cpu(name, resdiv, golden):
    """The port's plain torch path at the golden resolution: the JAX
    package's exact count (a few seconds each on the CPU)."""
    tree = getattr(torch_flagships, f"build_{name}")()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, "cpu")
    _, tri = fr.render_compact()
    assert len(tri) == golden


def test_stl_bytes_match_jax():
    _, _, _, (verts, tri), _ = render_both("flange")
    a, b = io.BytesIO(), io.BytesIO()
    n = write_binary_stl_indexed(a, verts, tri)
    jax_write_stl(b, verts, tri)
    assert n == 84 + 50 * len(tri)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("name", PARTS)
def test_numpy_decode_matches_native(name):
    _, _, (ids, cases, t), _, fr = render_both(name)
    args = (ids, cases, t, fr.nx, fr.ny, fr.nz, fr.origin, fr.res)
    v_nat, tri_nat = mc_decode(*args)
    v_np, tri_np = mc_decode_plain(*args)
    np.testing.assert_array_equal(tri_np, tri_nat)
    np.testing.assert_array_equal(v_np, v_nat)


def test_decode_rejects_unresolved_owner():
    _, _, (ids, cases, t), _, fr = render_both("flange")
    keep = np.ones(len(ids), bool)
    keep[len(ids) // 2] = False  # drop an owner cube some neighbour needs
    from gsdf_tpu_torch.native import _crossing_bits

    t_keep = np.repeat(keep, _crossing_bits(cases.astype(np.int32)).sum(axis=1))
    args = (ids[keep], cases[keep], t[t_keep], fr.nx, fr.ny, fr.nz, fr.origin, fr.res)
    with pytest.raises(ValueError):
        mc_decode(*args)
    with pytest.raises(ValueError):
        mc_decode_plain(*args)


def test_renderer_rejects_zero_resolution():
    tree = TorchBuilder().new_cylinder(1.0, 1.0)
    with pytest.raises(ValueError, match="resolution"):
        FlatRenderer(tree, 0.0, "cpu")
    jtree = JaxBuilder().new_cylinder(1.0, 1.0)
    with pytest.raises(ValueError, match="resolution"):
        JaxFlatRenderer(jtree, 0.0)


def test_renderer_rejects_empty_bounds():
    """Disjoint parts intersect into an inverted box: a loud ValueError, as
    in the JAX package."""
    b = TorchBuilder()
    tree = b.intersection(b.new_cylinder(1.0, 1.0), b.translate(b.new_cylinder(1.0, 1.0), 5, 0, 0))
    with pytest.raises(ValueError, match="not fine enough"):
        FlatRenderer(tree, 0.1, "cpu")
    jb = JaxBuilder()
    jtree = jb.intersection(
        jb.new_cylinder(1.0, 1.0), jb.translate(jb.new_cylinder(1.0, 1.0), 5, 0, 0)
    )
    with pytest.raises(ValueError, match="not fine enough"):
        JaxFlatRenderer(jtree, 0.1)


def test_bench_part_on_cpu():
    """The benchmark entry's helper end to end at a small size on the CPU:
    golden check against the JAX package's count at the same resdiv."""
    _, (_, jtri), _, _, _ = render_both("showerhead")
    ms, n, times = cli.bench_part(
        torch_flagships.build_showerhead(), RESDIV, len(jtri), 1, torch.device("cpu")
    )
    assert n == len(jtri) and len(times) == 1 and ms > 0
    with pytest.raises(RuntimeError, match="golden"):
        cli.bench_part(torch_flagships.build_showerhead(), RESDIV, n + 1, 1, "cpu")


def test_bench_line_carries_vs_baseline(monkeypatch, capsys):
    """bench_main's one JSON line (bench_part stubbed): the contract keys
    metric, value, unit and vs_baseline in the flange's part and in its
    secondary, the showerhead's, vs_baseline the JAX package's baseline
    ms (706 + 371 for the flange, 701 for the showerhead) over the value."""
    import json

    ms = {torch_flagships.GOLDEN_FLANGE_TRIS: 40.0, torch_flagships.GOLDEN_SHOWERHEAD_TRIS: 25.0}
    monkeypatch.setattr(cli, "bench_part", lambda obj, resdiv, golden, *a, **k: (
        ms[golden], golden, [ms[golden]]))
    cli.bench_main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for part, value, baseline in ((line, 40.0, 706.0 + 371.0), (line["secondary"], 25.0, 701.0)):
        assert {"metric", "value", "unit", "vs_baseline"} <= part.keys()
        assert part["value"] == value and part["unit"] == "ms"
        assert part["vs_baseline"] == baseline / value
    assert line["device"] == "cpu"

