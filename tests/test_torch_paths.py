"""The port's triangle paths against the JAX package's (CPU).

`FlatRenderer.render(fused=True)` (K1 + K3 + K7s), `render(fused=False)`
(K2 + classification + K3 + K7s) and `render_indexed()` (K1 + K3 + K7w)
of both packages on the four golden parts at resdiv 60: triangle counts
exact, soup triangles and welded vertices within atol=1e-5, `tri_idx`
exact. On the CPU each kernel wrapper runs its plain torch version; the
JAX package runs op by op (`jax.disable_jit`) so that XLA-CPU's FMA
contraction does not move its distances.

Also: the sphere golden (41,072 triangles, 68^3 evaluations), the slab
gates (staged, fused and compact slabs equal the whole grid bit for bit),
`evaluations()` against the JAX package's on every path, and each module
that holds a kernel (mc_emit: K3 and K7s; compact_field: K4;
fused_welded: K7w) against the JAX function on a seeded random grid. K3's
triangle count, triangle offsets and edge ranks (what K7s and K7w are
sized and placed by) are held against the JAX package's soup length and
its MC_TRI_COUNT table on the parts and on the random grids, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.ops import compact_field as jax_compact_field
from gsdf_tpu.ops import mc_emit as jax_mc_emit
from gsdf_tpu.ops.mc_tables import MC_TRI_COUNT as JAX_MC_TRI_COUNT
from gsdf_tpu.render.flat import FlatRenderer as JaxFlatRenderer
from gsdf_tpu_torch import Builder
from gsdf_tpu_torch import flagships
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.ops import compact_field, fused_welded, mc_emit
from gsdf_tpu_torch.render.flat import FlatRenderer, render_flat

RESDIV = 60
PARTS = ["flange", "showerhead", "bolt", "knurled"]
ATOL = 1e-5
_jax = {}


def jax_render(name, path):
    """The JAX package's render of a golden part at resdiv 60, op by op."""
    key = (name, path)
    if key not in _jax:
        tree = getattr(jax_flagships, f"build_{name}")()
        fr = JaxFlatRenderer(tree, tree.bounds().diagonal() / RESDIV)
        with jax.disable_jit():
            if path == "indexed":
                _jax[key] = fr.render_indexed()
            else:
                _jax[key] = fr.render(fused=path == "fused")
    return _jax[key]


def port_renderer(name):
    tree = getattr(flagships, f"build_{name}")()
    return FlatRenderer(tree, tree.bounds().diagonal() / RESDIV, "cpu")


@pytest.mark.parametrize("path", ["fused", "staged"])
@pytest.mark.parametrize("name", PARTS)
def test_soup_matches_jax(name, path):
    ref = jax_render(name, path)
    tris = port_renderer(name).render(fused=path == "fused")
    assert tris.dtype == np.float32 and tris.shape == ref.shape and len(tris) > 1000
    np.testing.assert_allclose(tris, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", PARTS)
def test_render_indexed_matches_jax(name):
    jverts, jtri = jax_render(name, "indexed")
    verts, tri = port_renderer(name).render_indexed()
    assert tri.dtype == np.int32 and verts.dtype == np.float32
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=ATOL)
    # the welded mesh is the soup, indexed (ulp-level differences allowed)
    np.testing.assert_allclose(verts[tri], jax_render(name, "fused"), rtol=0, atol=ATOL)


def _check_compaction_sums(comp, case_bytes, n_cubes, n_tris):
    """K3's triangle count, both block offsets and its edge ranks against
    numpy sums over the active cubes' case bytes (ascending ids), with the
    JAX package's triangle-count table."""
    j = np.asarray(case_bytes).astype(np.int64)
    ids = comp.ids.numpy().astype(np.int64)
    assert len(j) == len(ids)
    n_tri = JAX_MC_TRI_COUNT.astype(np.int64)[j]
    assert comp.n_tris == int(n_tri.sum()) == n_tris
    assert comp.tri_offsets.dtype == torch.int64
    np.testing.assert_array_equal(comp.tri_offsets.numpy(), (np.cumsum(n_tri) - n_tri)[::256])
    b0 = j & 1
    n_cross = (b0 != (j >> 1) & 1).astype(np.int64) + (b0 != (j >> 3) & 1) + (b0 != (j >> 4) & 1)
    assert comp.n_t == int(n_cross.sum())
    np.testing.assert_array_equal(comp.offsets.numpy(), (np.cumsum(n_cross) - n_cross)[::256])
    # edge ranks: the crossing edges of the active cubes below every 32nd id, then the total
    dense = np.zeros(n_cubes, np.int64)
    dense[ids] = n_cross
    want = np.concatenate([[0], np.cumsum(dense)])[np.r_[0:n_cubes:32, n_cubes]]
    assert comp.edge_ranks.dtype == torch.int32
    np.testing.assert_array_equal(comp.edge_ranks.numpy(), want)


@pytest.mark.parametrize("name", PARTS)
def test_compaction_triangle_sums_match_jax(name):
    """K3's plain version on a golden part's case grid: n_tris is the
    length of the JAX package's soup, and the offsets are the exclusive
    sums of its MC_TRI_COUNT[case] at every 256th active cube."""
    fr = port_renderer(name)
    _, cases = gk.classified_grid_plain(fr.s, fr.origin, fr.res, fr.shape(), fr.device)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    assert mc_emit.compact_active(cases).edge_ranks is None
    idx8 = cases.reshape(-1)[comp.ids.long()].numpy()
    _check_compaction_sums(comp, idx8, cases.numel(), len(jax_render(name, "fused")))
    assert comp.n_tris > 1000 and len(comp.tri_offsets) == -(-len(comp.ids) // 256)


def test_sphere_golden_triangle_count():
    """Sphere r=1 at res r/33: exactly 41,072 triangles, every corner
    evaluated once (reference glrender/glrender_test.go:96)."""
    fr = FlatRenderer(Builder().new_sphere(1.0), 1.0 / 33, "cpu")
    tris = fr.render()
    assert tris.shape == (41072, 3, 3)
    assert fr.evaluations() == 68**3
    assert render_flat(Builder().new_sphere(1.0), 1.0 / 33, "cpu").shape == (41072, 3, 3)


def _slab_scene(b):
    return b.difference(
        b.smooth_union(0.1, b.new_sphere(0.73), b.new_box(1.1, 0.9, 0.53, 0.05)),
        b.new_cylinder(0.21, 3.0, 0.0),
    )


SLAB_RES = 0.047  # deliberately non-dyadic: exercises rounding


def test_staged_slab_chunking_bitexact():
    """The staged path's z-slabs (K2 with an integer k0) equal the whole
    grid bit for bit (mirrors test_render_golden.py's JAX test)."""
    s = _slab_scene(Builder())
    whole = FlatRenderer(s, SLAB_RES, "cpu").render(fused=False)
    chunked = FlatRenderer(s, SLAB_RES, "cpu", max_slab_points=0).render(fused=False)
    assert len(whole) > 1000
    np.testing.assert_array_equal(chunked, whole)


def test_fused_slabs_bitexact():
    """The one-pass soup split into z-slabs past slab_cubes (K1 and K7s
    with the slab's k0) equals the one-slab render bit for bit."""
    s = _slab_scene(Builder())
    whole = FlatRenderer(s, SLAB_RES, "cpu").render()
    fr = FlatRenderer(s, SLAB_RES, "cpu")
    fr.slab_cubes = fr.nx * fr.ny * 5  # about nz/5 slabs
    np.testing.assert_array_equal(fr.render(), whole)
    np.testing.assert_array_equal(FlatRenderer(s, SLAB_RES, "cpu").render(fused=False), whole)


def test_compact_slab_gate_bitexact():
    """The compact path past compact_cubes: slab payloads concatenate into
    the whole grid's, and the meshes are equal bit for bit."""
    s = _slab_scene(Builder())
    whole = FlatRenderer(s, SLAB_RES, "cpu")
    wv, wt = whole.render_compact()
    fr = FlatRenderer(s, SLAB_RES, "cpu")
    nk, nj, ni = fr.shape()
    fr.compact_cubes = 7 * nj * ni  # slabs of at most 7 corner planes
    v, t = fr.render_compact()
    np.testing.assert_array_equal(t, wt)
    np.testing.assert_array_equal(v, wv)
    n_slabs = -(-nk * nj * ni // fr.compact_cubes)
    assert fr.evaluations() == whole.evaluations() + (n_slabs - 1) * nj * ni


@pytest.mark.parametrize(
    "path, setup",
    [
        ("fused", {}),
        ("staged", {"max_slab_points": 5000}),
        ("indexed", {}),
        ("indexed-soup", {"slab_cubes": 13000}),  # 24^3 corners: the host weld
        ("compact", {}),
        ("compact-slabs", {"compact_cubes": 5000}),
    ],
)
def test_evaluations_match_jax(path, setup):
    """evaluations() counts as the JAX package counts, path by path."""
    def run(fr):
        for k, v in setup.items():
            setattr(fr, k, v)
        if path == "fused":
            fr.render()
        elif path == "staged":
            fr.render(fused=False)
        elif path.startswith("indexed"):
            fr.render_indexed()
        else:
            fr.render_compact()
        return fr.evaluations()

    res = 0.8 / 11
    got = run(FlatRenderer(Builder().new_sphere(0.8), res, "cpu"))
    with jax.disable_jit():
        want = run(JaxFlatRenderer(JaxBuilder().new_sphere(0.8), res))
    assert got == want > 0


# --- each module that holds a kernel, on a seeded random grid ------------
def _random_grid(seed, shape=(9, 11, 13)):
    """Distances with many sign changes, exact zeros and values inside the
    1e-12 snap band, so every branch of the interpolation runs."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    g[rng.uniform(size=shape) < 0.05] = 0.0
    tiny = rng.uniform(size=shape) < 0.05
    g[tiny] = np.float32(5e-13) * np.sign(rng.normal(size=shape))[tiny].astype(np.float32)
    return g


ORIGIN = np.float32([-1.3, 0.7, -2.1])
RES = np.float32(0.37)


@pytest.mark.parametrize("seed", range(3))
def test_mc_emit_kernels_match_jax(seed):
    """K3 (compact_indices) and K7s (emit_triangles) on the port's side,
    the JAX package's dense_grid_mc on the other, with a slab offset."""
    g = _random_grid(seed)
    k0 = 7
    with jax.disable_jit():
        jtris, n_active, total = jax_mc_emit.dense_grid_mc(
            jnp.asarray(g), jnp.asarray(ORIGIN), RES, np.float32(k0), 2048, 8192
        )
        _, jactive = jax_mc_emit.classify(jnp.asarray(g), RES)
        jids = jax_mc_emit.compact_indices(jactive.reshape(-1), 2048)
    grid = torch.from_numpy(g)
    cases = mc_emit.effective_cases(grid, RES)
    ids = mc_emit.compact_indices(cases)
    assert ids.dtype == torch.int32 and len(ids) == int(n_active) > 100
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[: len(ids)])
    tris = mc_emit.emit_triangles(grid, cases, ids, ORIGIN, RES, k0)
    assert len(tris) == int(total)
    np.testing.assert_array_equal(tris.numpy(), np.asarray(jtris)[: int(total)])


@pytest.mark.parametrize("seed", range(3))
def test_compaction_triangle_sums_on_random_grid(seed):
    """K3's triangle count, offsets and edge ranks on a seeded random grid
    (more than 256 active cubes: several offsets) against the JAX
    package's classification, its table and its soup's length."""
    g = _random_grid(seed)
    with jax.disable_jit():
        _, _, total = jax_mc_emit.dense_grid_mc(
            jnp.asarray(g), jnp.asarray(ORIGIN), RES, np.float32(0), 2048, 8192
        )
        jindex, jactive = jax_mc_emit.classify(jnp.asarray(g), RES)
    jcases = np.asarray(jindex).reshape(-1)[np.asarray(jactive).reshape(-1)]
    cases = mc_emit.effective_cases(torch.from_numpy(g), RES)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    assert len(comp.tri_offsets) > 1
    _check_compaction_sums(comp, jcases, cases.numel(), int(total))


@pytest.mark.parametrize("seed", range(3))
def test_emit_keyword_forms_match_three_argument_forms(seed):
    """emit_triangles and emit_welded handed K3's counts and offsets give
    what the forms that run K3 themselves give."""
    grid = torch.from_numpy(_random_grid(seed))
    cases = mc_emit.effective_cases(grid, RES)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    for k0 in (0, 7):
        assert torch.equal(
            mc_emit.emit_triangles(grid, cases, comp.ids, ORIGIN, RES, k0,
                                   n_tris=comp.n_tris, tri_offsets=comp.tri_offsets),
            mc_emit.emit_triangles(grid, cases, comp.ids, ORIGIN, RES, k0),
        )
        with_comp = fused_welded.emit_welded(grid, cases, comp.ids, ORIGIN, RES, k0, comp=comp)
        alone = fused_welded.emit_welded(grid, cases, comp.ids, ORIGIN, RES, k0)
        assert all(torch.equal(a, b) for a, b in zip(with_comp, alone))
        assert len(with_comp[0]) == comp.n_t and len(with_comp[1]) == comp.n_tris
    assert torch.equal(mc_emit.dense_grid_mc(grid, cases, ORIGIN, RES, 7),
                       mc_emit.emit_triangles(grid, cases, comp.ids, ORIGIN, RES, 7))


@pytest.mark.parametrize("seed", range(3))
def test_compact_emit_matches_jax(seed):
    """K4 (compact_emit) against the JAX package's compact_emit payload."""
    g = _random_grid(seed)
    with jax.disable_jit():
        packed = jax_compact_field.compact_emit(jnp.asarray(g), RES, 2048, 4096, 4096)
    jids, jcases, jt, _ = jax_compact_field.unpack_compact_payload(np.asarray(packed), 2048, 4096)
    grid = torch.from_numpy(g)
    cases = mc_emit.effective_cases(grid, RES)
    ids = mc_emit.compact_indices(cases)
    idx8, t = compact_field.compact_emit(grid, cases, ids)
    np.testing.assert_array_equal(ids.numpy().view(np.uint32), jids)
    comp = mc_emit.compact_active(cases)  # K3 with K4's edge count and offsets
    assert comp.n_t == len(jt) and torch.equal(comp.ids, ids)
    n_cross = compact_field.crossing(torch.from_numpy(np.array(jcases))).sum(1)
    np.testing.assert_array_equal(comp.offsets.numpy(), (torch.cumsum(n_cross, 0) - n_cross)[::256])
    np.testing.assert_array_equal(idx8.numpy(), jcases)
    np.testing.assert_array_equal(t.numpy(), jt)
    assert (t.numpy() == 0).any() and (t.numpy() == 1).any()  # the snaps ran


@pytest.mark.parametrize("seed", range(3))
def test_emit_welded_indexes_the_soup(seed):
    """K7w (emit_welded): every resolved corner indexes the soup's vertex
    (within an ulp: one interpolation per owner edge), unresolved ones are
    -1 and counted, and vertices are the owner edges in cube-major x, y, z
    order (the JAX package's layout, fused_welded.py:123-144)."""
    g = _random_grid(seed)
    grid = torch.from_numpy(g)
    cases = mc_emit.effective_cases(grid, RES)
    ids = mc_emit.compact_indices(cases)
    verts, tri_idx, unresolved = fused_welded.emit_welded(grid, cases, ids, ORIGIN, RES)
    soup = mc_emit.emit_triangles(grid, cases, ids, ORIGIN, RES).numpy()
    tri, verts = tri_idx.numpy(), verts.numpy()
    assert tri.shape == soup.shape[:2] and int(unresolved) == int((tri < 0).sum()) > 0
    ok = tri >= 0
    np.testing.assert_allclose(verts[tri[ok]], soup[ok], rtol=0, atol=1e-6)
    idx8 = cases.reshape(-1)[ids.long()]
    assert len(verts) == int(compact_field.crossing(idx8).sum())
