"""The port's CUDA kernels against their plain torch versions on a card:
K1 classified grid, K2 grid eval, K3 compaction, K4 compact emit, K7s
soup emit and K7w welded emit, then every FlatRenderer path. Every test
here needs an NVIDIA GPU and nvcc and skips without them. This file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: case grids, ids, counts and tri_idx exact; t, soup and welded
vertices bit-identical (the kernels are built -fmad=false and fed the
same grid); distances within 1e-5 * max(1, |d|), the last-ulp difference
of CUDA's atan2f and torch.atan2.
"""
import numpy as np
import pytest
import torch

from gsdf_tpu_torch import Builder, flagships, kernels, with_bounds
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.forge import threads
from gsdf_tpu_torch.geometry.boxes import Box
from gsdf_tpu_torch.ops import compact_field, fused_welded, mc_emit
from gsdf_tpu_torch.render.flat import FlatRenderer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solid():
    b = Builder()
    hole = b.new_cylinder(0.12, 3.0)
    holes = b.union(*[b.translate(hole, 0.4 * np.cos(a), 0.4 * np.sin(a), 0)
                      for a in np.linspace(0, 5, 6)])
    body = b.smooth_union(
        0.15, b.new_cylinder(0.7, 0.6, 0.05), b.translate(b.new_cylinder(0.3, 1.2), 0, 0, 0.3)
    )
    return b.scale(b.intersection(b.difference(body, holes), b.new_cylinder(0.65, 2.0)), 1.3)


def _screw():
    return threads.screw(Builder(), 1.0, threads.ISO(d=1.2, p=0.25, ext=True))


def _every_type():
    import chip_smoke

    return chip_smoke.every_type_tree(Builder(), threads, with_bounds, Box)


TREES = {
    "solid": _solid,
    "screw": _screw,
    "flange": flagships.build_flange,
    "showerhead": flagships.build_showerhead,
    "bolt": flagships.build_bolt,
    "knurled": flagships.build_knurled,
    "every-type": _every_type,
}


@pytest.mark.parametrize("name", list(TREES))
def test_kernels_match_plain(name, cuda_device):
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    args = (tree, fr.origin, fr.res, fr.shape(), cuda_device)
    before = dict(gk.LAUNCHES)
    dist, cases = gk.classified_grid(*args)
    dist2 = gk.evaluate_grid(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["classified_grid"] == before["classified_grid"] + 1
    assert gk.LAUNCHES["grid_eval"] == before["grid_eval"] + 1
    ref_dist, ref_cases = gk.classified_grid_plain(*args)
    tol = 1e-5 * ref_dist.abs().clamp(min=1.0)
    assert bool(((dist - ref_dist).abs() <= tol).all())
    assert torch.equal(dist, dist2)
    assert torch.equal(cases, ref_cases)
    assert int((cases != 0).sum()) > 100


def test_grid_eval_slab_offset(cuda_device):
    """A z-slab launched with k0 equals the whole grid's planes bit for bit."""
    tree = _solid()
    origin, res = np.float32([-1.0, -1.0, -1.0]), np.float32(0.03)
    whole = gk.evaluate_grid(tree, origin, res, (40, 33, 65), cuda_device)
    slab = gk.evaluate_grid(tree, origin, res, (9, 33, 65), cuda_device, k0=17)
    assert torch.equal(whole[17:26], slab)


def test_classified_grid_slab_offset(cuda_device):
    """K1 on a z-slab launched with k0 equals the whole grid's planes."""
    tree = _solid()
    origin, res = np.float32([-1.0, -1.0, -1.0]), np.float32(0.03)
    whole_d, whole_c = gk.classified_grid(tree, origin, res, (40, 33, 65), cuda_device)
    d, c = gk.classified_grid(tree, origin, res, (9, 33, 65), cuda_device, k0=17)
    assert torch.equal(whole_d[17:26], d)
    assert torch.equal(whole_c[17:25], c)


def _counted(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("name", list(TREES))
def test_mc_kernels_match_plain(name, cuda_device):
    """K3, K4, K7s and K7w on K1's grid, each against its plain version."""
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    dist, cases = gk.classified_grid(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    ids = _counted("compact_active", lambda: mc_emit.compact_indices(cases))
    assert torch.equal(ids, mc_emit.compact_indices_plain(cases)) and len(ids) > 100
    idx8, t = _counted("compact_emit", lambda: compact_field.compact_emit(dist, cases, ids))
    ref_idx8, ref_t = compact_field.compact_emit_plain(dist, cases, ids)
    assert torch.equal(idx8, ref_idx8) and torch.equal(t, ref_t)
    for k0 in (0, 5):
        tris = _counted(
            "emit_soup", lambda: mc_emit.emit_triangles(dist, cases, ids, fr.origin, fr.res, k0)
        )
        assert torch.equal(
            tris, mc_emit.emit_triangles_plain(dist, cases, ids, fr.origin, fr.res, k0)
        )
    verts, tri_idx, unresolved = _counted(
        "emit_welded", lambda: fused_welded.emit_welded(dist, cases, ids, fr.origin, fr.res)
    )
    ref_verts, ref_tri, ref_unresolved = fused_welded.emit_welded_plain(
        dist, cases, ids, fr.origin, fr.res
    )
    assert torch.equal(verts, ref_verts) and torch.equal(tri_idx, ref_tri)
    assert unresolved == ref_unresolved
    assert len(tri_idx) == len(tris)


def cropped_part():
    import chip_smoke

    return chip_smoke.cropped_part(Builder(), with_bounds, Box)


def test_paths_agree_on_card(cuda_device):
    """Every FlatRenderer path on the card: the sphere golden, staged ==
    fused, indexed and compact meshes index that soup."""
    s = Builder().new_sphere(1.0)
    fr = FlatRenderer(s, 1.0 / 33, cuda_device)
    soup = fr.render()
    assert soup.shape == (41072, 3, 3) and fr.evaluations() == 68**3
    np.testing.assert_array_equal(FlatRenderer(s, 1.0 / 33, cuda_device).render(fused=False), soup)
    fr.slab_cubes = 20_000
    np.testing.assert_array_equal(fr.render(), soup)
    for verts, tri in (
        FlatRenderer(s, 1.0 / 33, cuda_device).render_indexed(),
        FlatRenderer(s, 1.0 / 33, cuda_device).render_compact(),
    ):
        np.testing.assert_allclose(verts[tri], soup, rtol=0, atol=1e-6)


def test_cropped_part_falls_back_on_card(cuda_device):
    tree = cropped_part()
    res = tree.bounds().diagonal() / 40
    fr = FlatRenderer(tree, res, cuda_device)
    _, _, unresolved = fused_welded.welded_render(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    assert unresolved > 0
    soup = FlatRenderer(tree, res, cuda_device).render()
    for verts, tri in (fr.render_indexed(), FlatRenderer(tree, res, cuda_device).render_compact()):
        assert tri.max() < len(verts)
        np.testing.assert_array_equal(verts[tri], soup)


def test_compact_slabs_on_card(cuda_device):
    tree = flagships.build_flange()
    res = tree.bounds().diagonal() / 120
    whole = FlatRenderer(tree, res, cuda_device).render_compact()
    fr = FlatRenderer(tree, res, cuda_device)
    nk, nj, ni = fr.shape()
    fr.compact_cubes = 10 * nj * ni
    v, t = fr.render_compact()
    np.testing.assert_array_equal(t, whole[1])
    np.testing.assert_array_equal(v, whole[0])


def test_render_compact_on_card_matches_plain_payload(cuda_device):
    """The card's compact path gives the plain version's triangles."""
    tree = flagships.build_flange()
    res = tree.bounds().diagonal() / 120
    verts, tri = FlatRenderer(tree, res, cuda_device).render_compact()
    fr = FlatRenderer(tree, res, cuda_device)
    d, c = gk.classified_grid_plain(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    from gsdf_tpu_torch.native import mc_decode

    ids = mc_emit.compact_indices_plain(c)
    idx8, t = compact_field.compact_emit_plain(d, c, ids)
    v_ref, tri_ref = mc_decode(
        ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(),
        t.cpu().numpy(), fr.nx, fr.ny, fr.nz, fr.origin, fr.res,
    )
    np.testing.assert_array_equal(tri, tri_ref)
    np.testing.assert_allclose(verts, v_ref, rtol=0, atol=1e-5)
