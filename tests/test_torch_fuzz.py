"""Random CSG trees through the port's paths against the JAX package's
(CPU).

The trees come from the JAX package's own path fuzz generator
(tests/test_fuzz_paths.py `_random_tree`, the seeds of its
test_all_paths_agree and test_cropped_bounds_paths_agree) and are carried
over with `from_reference_tree`; every unary op of the reference's
randomized set (rotate, scale, offset, shell, symmetry, twist, circular
array, elongate, translate, array) and the extrude/revolve leaves reach
the port this way. Each tree renders at diag/32, the JAX package op by op
(`jax.disable_jit`).

Tolerances: cube ids, case bytes, triangle counts and connectivity
exact; the owner-edge t within 1e-4 of a voxel edge, and vertices within
1e-4 voxel (ROADMAP item 4's rule: corner distances differ by an ulp of
sin, cos or atan2, which the interpolation amplifies where an edge nearly
cancels).

The cropped seeds 2 and 4 have surfaces that cross the grid's far faces.
There the JAX package's render_indexed returns sentinel indices (a fault
of the reference: fused_welded.py:151-153 clamps an owner past the grid,
:96-99 reads slot 0 for an inactive one); the port's welded emit counts
those corners and the renderer welds the soup instead.
"""
import jax
import numpy as np
import pytest
from test_fuzz_paths import _random_tree

from gsdf_tpu.core.wrappers import with_bounds as jax_with_bounds
from gsdf_tpu.geometry.boxes import Box as JaxBox
from gsdf_tpu.native import mc_decode as jax_mc_decode
from gsdf_tpu.ops.compact_field import compact_field_render as jax_compact_field_render
from gsdf_tpu.render.flat import FlatRenderer as JaxFlatRenderer
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.ops import fused_welded, mc_emit
from gsdf_tpu_torch.ops.compact_field import compact_field_render, crossing
from gsdf_tpu_torch.render.flat import FlatRenderer

T_TOL = 1e-4  # of a voxel edge
_jax = {}


def _tree(seed):
    jtree = _random_tree(np.random.default_rng(seed))
    if jtree is None:
        pytest.skip("builder rejected random combination")
    bbd = jtree.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or jtree.bounds().is_empty():
        pytest.skip("degenerate/empty bounds")
    ttree = from_reference_tree(jtree)
    assert ttree.tree_hash() == jtree.tree_hash()
    return jtree, ttree, bbd / 32


def _cropped_tree(seed):
    """test_cropped_bounds_paths_agree's tree: the part cropped to its
    inner 60%, so the surface crosses the render box."""
    jtree = _random_tree(np.random.default_rng(100 + seed))
    bb = jtree.bounds()
    jtree = jax_with_bounds(jtree, JaxBox(bb.min * 0.6, bb.max * 0.6))
    return jtree, from_reference_tree(jtree), jtree.bounds().diagonal() / 32


def jax_outputs(key, jtree, res):
    """(payload, soup) of the JAX package: compact_field_render's ids,
    cases and t, and FlatRenderer.render()'s triangles."""
    if key not in _jax:
        fr = JaxFlatRenderer(jtree, res)
        with jax.disable_jit():
            payload = jax_compact_field_render(
                jtree, fr.origin, fr.res, (fr.nz + 1, fr.ny + 1, fr.nx + 1),
                jax.devices("cpu")[0],
            )[:3]
            soup = fr.render()
        _jax[key] = (payload, soup, fr)
    return _jax[key]


def _close(a, b, res):
    np.testing.assert_allclose(a, b, rtol=0, atol=T_TOL * res + 1e-6)


@pytest.mark.parametrize("seed", range(10))
def test_random_tree_payload_matches_jax(seed):
    jtree, ttree, res = _tree(seed)
    (jids, jcases, jt), _, _ = jax_outputs(seed, jtree, res)
    fr = FlatRenderer(ttree, res, "cpu")
    ids, cases, t = compact_field_render(ttree, fr.origin, fr.res, fr.shape(), "cpu")
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cases, jcases)
    assert len(t) == len(jt)
    dt = np.abs(t.astype(np.float64) - jt.astype(np.float64))
    assert dt.max(initial=0.0) <= T_TOL, f"t drift {dt.max():.2e} > {T_TOL} voxel"


@pytest.mark.parametrize("seed", range(10))
def test_random_tree_mesh_matches_jax(seed):
    """render_compact's mesh against the JAX package's: its payload
    decoded by its native decoder, which is what its render_compact
    returns unless an owner cube is unresolved. Where it is (seed 0), both
    packages fall back, and the port's mesh is the welded soup."""
    jtree, ttree, res = _tree(seed)
    (jids, jcases, jt), soup, jfr = jax_outputs(seed, jtree, res)
    verts, tri = FlatRenderer(ttree, res, "cpu").render_compact()
    try:
        jverts, jtri = jax_mc_decode(
            jids, jcases, jt, jfr.nx, jfr.ny, jfr.nz, jfr.origin, jfr.res
        )
    except ValueError:
        assert tri.max() < len(verts)
    else:
        np.testing.assert_array_equal(tri, jtri)
        _close(verts, jverts, res)
    _close(verts[tri], soup, res)


@pytest.mark.parametrize("seed", range(10))
def test_all_paths_agree(seed):
    """The JAX package's test_all_paths_agree on the port: the fused and
    staged soups, render_indexed and render_compact agree (:169-180), and
    the soup matches the JAX package's."""
    jtree, ttree, res = _tree(seed)
    _, jsoup, _ = jax_outputs(seed, jtree, res)
    fused = FlatRenderer(ttree, res, "cpu").render(fused=True)
    staged = FlatRenderer(ttree, res, "cpu").render(fused=False)
    np.testing.assert_array_equal(fused, staged)
    wv, wt = FlatRenderer(ttree, res, "cpu").render_indexed()
    assert len(wt) == len(fused)
    cv, ct = FlatRenderer(ttree, res, "cpu").render_compact()
    np.testing.assert_array_equal(ct, wt)
    np.testing.assert_allclose(cv, wv, rtol=0, atol=1e-5)
    assert len(fused) == len(jsoup)
    _close(fused, jsoup, res)
    if len(fused):
        assert np.isfinite(fused).all()


@pytest.mark.parametrize("seed", range(10))
def test_random_tree_triangle_count_matches_jax(seed):
    """K3's triangle count on a random tree's case grid is the length of
    the JAX package's soup, and its last triangle offset plus the last
    block's triangles closes on it: what K7s and K7w allocate by."""
    jtree, ttree, res = _tree(seed)
    _, jsoup, _ = jax_outputs(seed, jtree, res)
    fr = FlatRenderer(ttree, res, "cpu")
    _, cases = gk.classified_grid(ttree, fr.origin, fr.res, fr.shape(), "cpu")
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    assert comp.n_tris == len(jsoup)
    n_tri = mc_emit.MC_TRI_COUNT[cases.reshape(-1)[comp.ids.long()].numpy()].astype(np.int64)
    np.testing.assert_array_equal(comp.tri_offsets.numpy(), (np.cumsum(n_tri) - n_tri)[::256])
    assert int(comp.edge_ranks[-1]) == comp.n_t and comp.edge_ranks[0] == 0
    verts, tri, _ = fused_welded.emit_welded(
        *gk.classified_grid(ttree, fr.origin, fr.res, fr.shape(), "cpu"), comp.ids,
        fr.origin, fr.res, comp=comp)
    assert len(verts) == comp.n_t and len(tri) == comp.n_tris


@pytest.mark.parametrize("seed", [2, 4])
def test_cropped_seed_falls_back(seed):
    """Where owner cubes lie past the grid, the JAX package's welded mesh
    holds sentinel indices >= V (the reference fault); the port's
    render_indexed and render_compact fall back to welding the soup: every
    index < V, and the mesh is the JAX package's soup."""
    jtree, ttree, res = _cropped_tree(seed)
    with jax.disable_jit():
        jverts, jtri = JaxFlatRenderer(jtree, res).render_indexed()
        jsoup = JaxFlatRenderer(jtree, res).render()
    assert (jtri >= len(jverts)).any(), "the reference's fault is gone: update this test"

    fr = FlatRenderer(ttree, res, "cpu")
    _, _, unresolved = fused_welded.welded_render(ttree, fr.origin, fr.res, fr.shape(), "cpu")
    assert unresolved > 0
    for verts, tri in (fr.render_indexed(), FlatRenderer(ttree, res, "cpu").render_compact()):
        assert len(tri) == len(jsoup) and tri.min() >= 0 and tri.max() < len(verts)
        _close(verts[tri], jsoup, res)


def test_cropped_seed2_welded_slot_map():
    """Cropped seed 2 has cube 0 active (the surface touches the grid's
    min corner, the trap of the reference's commit 122c151, where padding
    rows overwrote cube 0's slot): the welded emit's cube -> slot map must
    hold every active cube's own slot, so every resolved corner indexes the
    soup's vertex."""
    _, ttree, res = _cropped_tree(2)
    fr = FlatRenderer(ttree, res, "cpu")
    dist, cases = gk.classified_grid(ttree, fr.origin, fr.res, fr.shape(), "cpu")
    ids = mc_emit.compact_indices(cases)
    assert int(ids[0]) == 0
    verts, tri, unresolved = fused_welded.emit_welded(dist, cases, ids, fr.origin, fr.res)
    soup = mc_emit.emit_triangles(dist, cases, ids, fr.origin, fr.res).numpy()
    tri, verts = tri.numpy(), verts.numpy()
    ok = tri >= 0
    assert int(unresolved) == int((~ok).sum()) > 0
    np.testing.assert_allclose(verts[tri[ok]], soup[ok], rtol=0, atol=1e-5)
    assert len(verts) == int(crossing(cases.reshape(-1)[ids.long()]).sum())
