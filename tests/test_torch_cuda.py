"""The port's CUDA kernels against their plain torch versions on a card:
K1 classified grid, K2 grid eval, K3 compaction, K4 compact emit, K7s
soup emit and K7w welded emit, then every FlatRenderer path; KP point
eval and K2-2D pixel-grid eval, then the evaluators and the PNG path. Every test
here needs an NVIDIA GPU and nvcc and skips without them. This file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Also K1 on ragged shapes and a slab at k0 = 83, K3 at tile edges, past
40 waves of tiles and on an unaligned view, K7s and K7w on seeded random
grids (ragged shapes, a block count that is no multiple of 256, k0 = 83,
cube 0 active, far faces crossed), on a grid whose every cube emits five
triangles (the shared-memory stage at its limit) and back to back, and
every path's one count read before its fetch. Last, the parametric forms
K1p and KPp: against plain and against the baked kernels (bit for bit), the
same library with another tree's values, by value and through a pointer,
the edit loop with no compiler run and no library loaded, and a failed
build raising instead of falling back. Then K5 and K5p (dual contouring)
against their plain version on every tree in both modes and on a slab at
k0 != 0 with a halo layer, K5's grid pass equal to K2's in every float,
one count read before the fetch, the bolt's three goldens and the DC edit
loop. Then the pruned renderer's kernels: K6c and K6a (baked and
parametric), the id map and K7s's tile mode against their plain versions
on every tree with tiles of 8 and 7, the atlas equal to K1's grid at the
same corners, K7s's dense mode unchanged (and a one-tile atlas placed as
the dense grid), the pruned payload equal to the dense one with its
launches per batch, the flange's golden, the soup and the edit loop.
Last, the raymarcher: K8 and K8p against their plain version on every
tree at aa 1 and 2 (every pixel and every ray's evaluation count), K8p
with another tree's values through one library, one library across
frame sizes, steps and aa, the showerhead's short-circuit sites (K8 and
its counting form at the viewer's rest frame, the counter), a polygon's
edge divisions against a recount from the plain's evaluations,
the launch's argument checks, the entry
points' default device, the GEB sculpture's viewer frames against the
CPU's, the viewer's frames with no build after the first, and pipelined
drag frames one view behind.

Tolerances: case grids, ids, counts, K3's block offsets and edge ranks and tri_idx exact; t, soup and welded
vertices bit-identical (the kernels are built -fmad=false and fed the
same grid); distances within 1e-5 * max(1, |d|), the last-ulp difference
of CUDA's atan2f and torch.atan2. K5: edge ids, flips and live-voxel
counts exact, vertices within 1e-4 * res of the plain version (measured
0).
"""
import numpy as np
import pytest
import torch

from gsdf_tpu_torch import Builder, _build, flagships, kernels, with_bounds
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.eval import point_kernels as pk
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
    "geb": flagships.build_geb,
}


@pytest.mark.parametrize("name", list(TREES))
def test_kernels_match_plain(name, cuda_device):
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    args = (tree, fr.origin, fr.res, fr.shape(), cuda_device)
    before = dict(kernels.LAUNCHES)
    dist, cases = gk.classified_grid(*args)
    dist2 = gk.evaluate_grid(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["classified_grid"] == before["classified_grid"] + 1
    assert kernels.LAUNCHES["grid_eval"] == before["grid_eval"] + 1
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


def _centred(shape):
    """(origin, res) of a grid of `shape` corners centred on the origin,
    its longest axis 2.8 long: every shape crosses _solid()'s surface."""
    res = np.float32(2.8 / max(shape))
    origin = np.float32([-(n - 1) / 2 * res for n in reversed(shape)])
    return origin, res


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 9, 257), (17, 8, 33), (24, 251, 251)])
def test_classified_grid_ragged_shapes(shape, cuda_device):
    """K1's two passes at shapes that are multiples of no tile: cases equal
    to plain, distances equal to K2's bit for bit."""
    tree = _solid()
    origin, res = _centred(shape)
    dist, cases = gk.classified_grid(tree, origin, res, shape, cuda_device)
    ref_dist, ref_cases = gk.classified_grid_plain(tree, origin, res, shape, cuda_device)
    assert torch.equal(dist, gk.evaluate_grid(tree, origin, res, shape, cuda_device))
    assert bool(((dist - ref_dist).abs() <= 1e-5 * ref_dist.abs().clamp(min=1.0)).all())
    assert torch.equal(cases, ref_cases)
    if min(shape) > 2:
        assert int((cases != 0).sum()) > 0


def test_classified_grid_slab_k0_83(cuda_device):
    """A slab at k0 = 83 (flange 800's second soup slab's offset)."""
    tree = _solid()
    origin, res = _centred((100, 33, 65))
    d, c = gk.classified_grid(tree, origin, res, (9, 33, 65), cuda_device, k0=83)
    ref_d, ref_c = gk.classified_grid_plain(tree, origin, res, (9, 33, 65), cuda_device, k0=83)
    assert torch.equal(c, ref_c) and int((c != 0).sum()) > 0
    assert torch.equal(d, gk.evaluate_grid(tree, origin, res, (9, 33, 65), cuda_device, k0=83))
    whole_d, whole_c = gk.classified_grid(tree, origin, res, (100, 33, 65), cuda_device)
    assert torch.equal(whole_d[83:92], d) and torch.equal(whole_c[83:91], c)


def _case_bytes(n, density, seed, device):
    """n random case bytes, a `density` share active (1-254), the rest 0,
    made on the card from a seeded generator."""
    g = torch.Generator(device).manual_seed(seed)
    c = torch.randint(1, 255, (n,), dtype=torch.uint8, generator=g, device=device)
    c[torch.rand(n, generator=g, device=device) >= density] = 0
    return c


#: K3's tile (case bytes per block) and the tiles resident at once on an
#: H100 (132 SMs, 2 blocks of 1024 threads each)
K3_TILE = 32768
K3_WAVE = 132 * 2


def _same_compaction(cases):
    comp = _counted("compact_active", lambda: mc_emit.compact_active(cases, edge_ranks=True))
    ref = mc_emit.compact_active_plain(cases, edge_ranks=True)
    assert torch.equal(comp.ids, ref.ids)
    assert (comp.n_t, comp.n_tris) == (ref.n_t, ref.n_tris)
    assert torch.equal(comp.offsets, ref.offsets)
    assert torch.equal(comp.tri_offsets, ref.tri_offsets)
    assert torch.equal(comp.edge_ranks, ref.edge_ranks)
    bare = mc_emit.compact_active(cases)  # no directory asked for: none written
    assert bare.edge_ranks is None and torch.equal(bare.ids, ref.ids)
    assert (bare.n_t, bare.n_tris) == (ref.n_t, ref.n_tris)
    assert torch.equal(bare.offsets, ref.offsets) and torch.equal(bare.tri_offsets, ref.tri_offsets)
    return comp


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, K3_TILE - 1, K3_TILE, K3_TILE + 1,
                               40 * K3_WAVE * K3_TILE + 777])
@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
def test_compact_active_matches_plain(n, density, cuda_device):
    """K3's one pass: tile edges, a short last tile, more than 40 waves of
    tiles, empty and full grids. Ids, (n_active, n_t, n_tris), both block
    offsets and the edge-rank directory equal the plain version's."""
    comp = _same_compaction(_case_bytes(n, density, n, cuda_device))
    if density == 0.0:
        assert len(comp.ids) == 0 and comp.n_t == 0 and len(comp.offsets) == 0
        assert comp.n_tris == 0 and len(comp.tri_offsets) == 0
    if density == 1.0:
        assert len(comp.ids) == n


def test_compact_active_unaligned_view_and_back_to_back(cuda_device):
    """A view that starts one byte into its buffer (no 16-byte loads at
    the tile edges), then two calls in a row on different grids: no status
    leaks from one call into the next."""
    buf = _case_bytes(3 * K3_TILE + 51, 0.2, 7, cuda_device)
    _same_compaction(buf[1:])
    a = _same_compaction(_case_bytes(100_003, 0.5, 8, cuda_device))
    b = _same_compaction(_case_bytes(50_001, 0.01, 9, cuda_device))
    assert len(a.ids) > len(b.ids) > 0


def _synchronising(fn):
    """(fn's result, the synchronising calls torch warned of inside it)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno} {w.message}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def _flange_args(cuda_device, resdiv=120):
    tree = flagships.build_flange()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, cuda_device)
    return tree, fr.origin, fr.res, fr.shape(), cuda_device


def test_compact_path_reads_counts_once(cuda_device):
    """Up to its fetch the compact path synchronises once: K3's count read.
    K4 takes K3's edge count and offsets and reads nothing."""
    args = _flange_args(cuda_device)
    compact_field.compact_field_render(*args)  # builds the kernels
    torch.cuda.synchronize()

    def until_fetch():
        dist, cases = gk.classified_grid(*args)
        comp = mc_emit.compact_active(cases)
        return (comp.ids, *compact_field.compact_emit(dist, cases, comp.ids, comp.n_t,
                                                      comp.offsets))

    payload, syncs = _synchronising(until_fetch)
    assert len(syncs) == 1, syncs
    _, fetch = _synchronising(lambda: [a.cpu() for a in payload])
    _, whole = _synchronising(lambda: compact_field.compact_field_render(*args))
    assert len(whole) == 1 + len(fetch), whole


@pytest.mark.parametrize("path", ["soup", "staged", "indexed"])
def test_triangle_paths_read_counts_once(path, cuda_device):
    """Up to its fetch each triangle path synchronises once, at K3's count
    read: K7s and K7w take their sizes and block offsets from K3 and read
    nothing, and the indexed path's fetch is one copy (vertices, indices
    and the unresolved count in one buffer)."""
    tree, origin, res, shape, dev = args = _flange_args(cuda_device)

    def emitted():
        if path == "staged":
            dist = gk.evaluate_grid(*args)
            cases = mc_emit.effective_cases(dist, res)
        else:
            dist, cases = gk.classified_grid(*args)
        comp = mc_emit.compact_active(cases, edge_ranks=path == "indexed")
        if path == "indexed":
            return fused_welded.emit_welded(dist, cases, comp.ids, origin, res, comp=comp)
        return mc_emit.emit_triangles(dist, cases, comp.ids, origin, res, 0, comp.n_tris,
                                      comp.tri_offsets)

    def whole():
        if path == "indexed":
            return fused_welded.welded_render(*args)
        fr = FlatRenderer(tree, res, dev)
        return fr.render(fused=path == "soup")

    whole()  # builds the kernels
    torch.cuda.synchronize()
    _, syncs = _synchronising(emitted)
    assert len(syncs) == 1, syncs
    _, syncs = _synchronising(whole)
    assert len(syncs) == 2, syncs  # K3's counts, then the fetch


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
    assert int(unresolved) == int(ref_unresolved)
    assert len(tri_idx) == len(tris)


def _random_grid(seed, shape, device):
    """Seeded distances with many sign changes, exact zeros and values
    inside the 1e-12 snap band, so every branch of the interpolation runs;
    with a coarse `res` every mixed cube is active: cube 0 among them, and
    the surface crosses every face of the grid."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    g[rng.uniform(size=shape) < 0.05] = 0.0
    tiny = rng.uniform(size=shape) < 0.05
    g[tiny] = np.float32(5e-13) * np.sign(rng.normal(size=shape))[tiny].astype(np.float32)
    return torch.from_numpy(g).to(device)


def _five_triangle_grid(shape, device):
    """Distances whose signs repeat with period 2 so that every cube's
    case emits five triangles, the most a cube can, and all three owner
    edges of every other cube cross: K7s's stage holds 256 x 5 triangles
    in every whole block."""
    k, j, i = np.meshgrid(*(np.arange(n) % 2 for n in shape), indexing="ij")
    sign = np.where(i + j + k == 1, 1.0, -1.0)
    mag = np.random.default_rng(5).uniform(0.1, 1.0, shape)
    return torch.from_numpy((sign * mag).astype(np.float32)).to(device)


def _emits_match_plain(grid, res, origin, k0):
    """K7s and K7w on `grid`, in both call forms, against plain."""
    cases = mc_emit.effective_cases(grid, res)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    ids = comp.ids
    ref_tris = mc_emit.emit_triangles_plain(grid, cases, ids, origin, res, k0)
    ref_verts, ref_tri, ref_unresolved = fused_welded.emit_welded_plain(
        grid, cases, ids, origin, res, k0)
    assert comp.n_tris == len(ref_tris) and comp.n_t == len(ref_verts)
    for tris in (
        _counted("emit_soup", lambda: mc_emit.emit_triangles(
            grid, cases, ids, origin, res, k0, comp.n_tris, comp.tri_offsets)),
        _counted("emit_soup", lambda: mc_emit.emit_triangles(grid, cases, ids, origin, res, k0)),
    ):
        assert torch.equal(tris, ref_tris)
    for verts, tri, unresolved in (
        _counted("emit_welded", lambda: fused_welded.emit_welded(
            grid, cases, ids, origin, res, k0, comp=comp)),
        _counted("emit_welded", lambda: fused_welded.emit_welded(
            grid, cases, ids, origin, res, k0)),
    ):
        assert torch.equal(verts, ref_verts) and torch.equal(tri, ref_tri)
        assert int(unresolved) == int(ref_unresolved) == int((ref_tri < 0).sum())
    return comp, ref_tris, ref_tri


EMIT_ORIGIN = np.float32([-1.3, 0.7, -2.1])
EMIT_RES = np.float32(0.37)


@pytest.mark.parametrize("k0", [0, 83])
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 9, 257), (17, 8, 33), (9, 11, 13),
                                   (33, 65, 40)])
def test_emit_kernels_ragged_shapes(shape, k0, cuda_device):
    """K7s and K7w bit-identical to plain on seeded random grids: shapes
    that are multiples of nothing, active counts that are no multiple of
    256 (a short last block), a slab offset, cube 0 active (the slot trap
    of the reference's commit 122c151) and owners past every far face."""
    grid = _random_grid(sum(shape) + 1, shape, cuda_device)
    comp, ref_tris, ref_tri = _emits_match_plain(grid, EMIT_RES, EMIT_ORIGIN, k0)
    if shape != (2, 2, 2):
        assert len(comp.ids) % 256 != 0 and int(comp.ids[0]) == 0
        assert len(ref_tris) > 100 and int((ref_tri < 0).sum()) > 0


def test_emit_kernels_full_stage(cuda_device):
    """Every cube emits five triangles: whole blocks of 256 x 5 triangles
    (K7s's stage at its limit) and a short last block."""
    grid = _five_triangle_grid((12, 13, 14), cuda_device)
    comp, ref_tris, _ = _emits_match_plain(grid, np.float32(10.0), EMIT_ORIGIN, 0)
    assert len(comp.ids) == 11 * 12 * 13 > 256 and len(ref_tris) == 5 * len(comp.ids)
    assert torch.equal(comp.tri_offsets, 5 * 256 * torch.arange(len(comp.tri_offsets),
                                                                device=cuda_device))


def test_emit_kernels_back_to_back(cuda_device):
    """Two grids through K3, K7s and K7w in a row on one stream, nothing
    awaited in between: no stage, count or directory leaks from one call
    into the next."""
    grids = [_random_grid(s, shape, cuda_device)
             for s, shape in ((1, (20, 21, 22)), (2, (9, 40, 17)))]
    outs = []
    for grid in grids:
        cases = mc_emit.effective_cases(grid, EMIT_RES)
        comp = mc_emit.compact_active(cases, edge_ranks=True)
        outs.append((
            cases, comp,
            mc_emit.emit_triangles(grid, cases, comp.ids, EMIT_ORIGIN, EMIT_RES, 3,
                                   comp.n_tris, comp.tri_offsets),
            fused_welded.emit_welded(grid, cases, comp.ids, EMIT_ORIGIN, EMIT_RES, 3, comp=comp),
        ))
    torch.cuda.synchronize()
    for grid, (cases, comp, tris, (verts, tri, unresolved)) in zip(grids, outs):
        assert torch.equal(
            tris, mc_emit.emit_triangles_plain(grid, cases, comp.ids, EMIT_ORIGIN, EMIT_RES, 3))
        ref_verts, ref_tri, ref_unresolved = fused_welded.emit_welded_plain(
            grid, cases, comp.ids, EMIT_ORIGIN, EMIT_RES, 3)
        assert torch.equal(verts, ref_verts) and torch.equal(tri, ref_tri)
        assert int(unresolved) == int(ref_unresolved) > 0


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


# --- KP (point eval) and K2-2D (pixel-grid eval) --------------------------
def _recipes_2d():
    import chip_smoke

    return chip_smoke.recipes_2d(Builder(), with_bounds, Box)


#: the 2D trees: one recipe per 2D node type and the three PNG scenes
TREES_2D = {**{name: (lambda name=name: _recipes_2d()[name]) for name in _recipes_2d()},
            **{name: (lambda make=make: make(Builder())) for name, make, _, _ in flagships.PNG_SCENES}}


def _points(tree, n, seed, device):
    import chip_smoke

    return chip_smoke.seeded_points(tree, n, seed, device)


def _close(d, ref):
    return bool(((d - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("name", list(TREES))
def test_point_eval_matches_plain(name, cuda_device):
    """KP at seeded points of a 3D tree: within tolerance of plain, one
    launch a call."""
    tree = TREES[name]()
    pos = _points(tree, 1 << 15, 1, cuda_device)
    d = _counted("point_eval", lambda: pk.evaluate_points(tree, pos, cuda_device))
    assert d.shape == (1 << 15,) and d.dtype == torch.float32 and d.device == cuda_device
    assert _close(d, pk.point_eval_plain(tree, pos))
    assert bool((d < 0).any()) and bool((d > 0).any())


@pytest.mark.parametrize("name", list(TREES_2D))
def test_2d_kernels_match_plain(name, cuda_device):
    """KP and K2-2D on a 2D root: each within tolerance of its plain
    version, and KP at the pixels' positions equal to K2-2D bit for bit."""
    tree = TREES_2D[name]()
    pos = _points(tree, 1 << 14, 1, cuda_device)
    d = _counted("point_eval", lambda: pk.evaluate_points(tree, pos, cuda_device))
    assert _close(d, pk.point_eval_plain(tree, pos))
    w, h = 203, 97
    field = _counted("grid_eval_2d", lambda: pk.distance_field(tree, w, h, cuda_device))
    assert field.shape == (h, w) and field.dtype == torch.float32
    assert _close(field, pk.distance_field_plain(tree, w, h, cuda_device))
    pixels = pk.pixel_positions(tree, w, h, cuda_device).reshape(-1, 2).contiguous()
    assert torch.equal(pk.evaluate_points(tree, pixels, cuda_device).reshape(h, w), field)


@pytest.mark.parametrize("name", ["solid", "flange", "bolt", "every-type"])
def test_point_eval_equals_grid_eval_at_grid_positions(name, cuda_device):
    """Same tree, same bits: KP fed a grid's positions gives K2's grid,
    at a slab offset too."""
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 70, cuda_device)
    for shape, k0 in ((fr.shape(), 0), ((5, fr.ny + 1, fr.nx + 1), 11)):
        grid = gk.evaluate_grid(tree, fr.origin, fr.res, shape, cuda_device, k0)
        pos = gk.grid_positions(fr.origin, fr.res, shape, cuda_device, k0).reshape(-1, 3)
        assert torch.equal(pk.evaluate_points(tree, pos.contiguous(), cuda_device).reshape(shape),
                           grid)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003])
def test_point_eval_any_batch_length(n, cuda_device):
    """Whole tiles of 256 points, a short last tile, one point: each
    point's distance is the one it gets in any other batch."""
    tree = _solid()
    pos = _points(tree, 100_003, 2, cuda_device)
    whole = pk.evaluate_points(tree, pos, cuda_device)
    part = _counted("point_eval", lambda: pk.evaluate_points(tree, pos[:n].contiguous(),
                                                             cuda_device))
    assert torch.equal(part, whole[:n])
    tail = pk.evaluate_points(tree, pos[-n:], cuda_device)  # a view that starts mid-buffer
    assert torch.equal(tail, whole[-n:])


def test_point_eval_empty_batch_launches_nothing(cuda_device):
    before = kernels.LAUNCHES["point_eval"]
    out = pk.evaluate_points(_solid(), torch.empty((0, 3), device=cuda_device), cuda_device)
    assert out.shape == (0,) and out.device == cuda_device
    assert kernels.LAUNCHES["point_eval"] == before


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """A CUDA device with a CPU tensor, a wrong dtype, shape or layout:
    the wrapper raises; it never gives way to the plain version."""
    tree = _solid()
    good = torch.zeros((8, 3), device=cuda_device)
    before = dict(kernels.LAUNCHES)
    for bad in (good.cpu(), good.double(), good.half(), good[:, :2], torch.zeros((8, 6),
                device=cuda_device)[:, ::2], good.reshape(-1)):
        with pytest.raises(ValueError):
            pk.evaluate_points(tree, bad, cuda_device)
    with pytest.raises(ValueError):
        pk.evaluate_points(tree, good, "cpu")  # a CUDA tensor with the CPU named
    with pytest.raises(TypeError):
        pk.distance_field(tree, 8, 8, cuda_device)  # a 3D tree
    with pytest.raises(ValueError):
        pk.distance_field(Builder().new_circle(1.0), 0, 8, cuda_device)
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("w,h", [(1, 1), (257, 3), (3, 1025)])
def test_distance_field_ragged_sizes(w, h, cuda_device):
    tree = flagships.mandala_scene2d(Builder())
    field = pk.distance_field(tree, w, h, cuda_device)
    assert torch.equal(field, pk.distance_field_plain(tree, w, h, cuda_device))


def test_evaluators_on_card(cuda_device):
    """With no device named the evaluators run on the card: one KP launch
    per evaluate after the constructor's, six per normals call (equal to
    the six-call host form bit for bit), no synchronising call inside
    evaluate_device."""
    from gsdf_tpu_torch.eval import new_cpu_sdf3, new_sdf3, normals_central_diff

    tree = flagships.build_bolt()
    before = kernels.LAUNCHES["point_eval"]
    sdf = new_sdf3(tree)
    assert sdf.device == cuda_device and sdf.evaluations() == 0
    assert kernels.LAUNCHES["point_eval"] == before + 1
    pts = _points(tree, 50_000, 3, "cpu").numpy()
    d = _counted("point_eval", lambda: sdf.evaluate(pts))
    assert d.dtype == np.float32 and sdf.evaluations() == 50_000
    np.testing.assert_allclose(d, new_cpu_sdf3(tree).evaluate(pts), rtol=1e-5, atol=1e-5)
    pos = torch.from_numpy(pts).to(cuda_device)
    on_card, syncs = _synchronising(lambda: sdf.evaluate_device(pos.reshape(50, 1000, 3)))
    assert not syncs and on_card.shape == (50, 1000)
    np.testing.assert_array_equal(on_card.reshape(-1).cpu().numpy(), d)

    import chip_smoke

    before = kernels.LAUNCHES["point_eval"]
    normals = normals_central_diff(sdf, pts, 0.02)
    assert kernels.LAUNCHES["point_eval"] == before + 6
    np.testing.assert_array_equal(
        normals, normals_central_diff(chip_smoke.HostOnly(sdf), pts, 0.02))
    assert FlatRenderer(tree, 0.5).device == cuda_device


def test_png_path_on_card(cuda_device, tmp_path):
    """render_png_file_2d on the default device: one K2-2D launch, the
    image equal to the plain version's, the PNG read back equal."""
    from PIL import Image

    from gsdf_tpu_torch import pipeline, render

    tree = flagships.mandala_scene2d(Builder())
    path = str(tmp_path / "mandala.png")
    img = _counted("grid_eval_2d", lambda: pipeline.render_png_file_2d(path, tree, 300, 200))
    plain = pk.distance_field_plain(tree, 300, 200, cuda_device).cpu().numpy()
    np.testing.assert_array_equal(img, render.bw_conversion(plain))
    with Image.open(path) as f:
        np.testing.assert_array_equal(np.asarray(f), img)


# --- the parametric forms K1p and KPp ------------------------------------
def _perturbed(tree):
    import chip_smoke

    return chip_smoke.perturbed(tree)


@pytest.mark.parametrize("name", list(TREES))
def test_parametric_kernels_match_plain_and_baked(name, cuda_device):
    """K1p and KPp against their plain versions (cases exact, distances
    within 1e-5 * max(1, |d|)) and against the baked K1 and KP bit for bit
    (the same float32 operations in the same order); then the same two
    libraries with a structurally equal tree's values."""
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    grid = (fr.origin, fr.res, fr.shape(), cuda_device)
    before = dict(kernels.LAUNCHES)
    dist, cases = gk.classified_grid(tree, *grid, parametric=True)
    assert kernels.LAUNCHES["classified_grid_param"] == before["classified_grid_param"] + 1
    assert kernels.LAUNCHES["classified_grid"] == before["classified_grid"]
    baked_dist, baked_cases = gk.classified_grid(tree, *grid)
    ref_dist, ref_cases = gk.classified_grid_plain(tree, *grid)
    tol = 1e-5 * ref_dist.abs().clamp(min=1.0)
    assert bool(((dist - ref_dist).abs() <= tol).all())
    assert torch.equal(cases, ref_cases)
    assert torch.equal(dist, baked_dist) and torch.equal(cases, baked_cases)
    pos = gk.grid_positions(*grid).reshape(-1, 3).contiguous()
    at_corners = pk.evaluate_points(tree, pos, cuda_device, parametric=True)
    assert torch.equal(at_corners.reshape(dist.shape), dist)
    assert kernels.LAUNCHES["point_eval_param"] == before["point_eval_param"] + 1
    other = _perturbed(tree)
    libs, counts = len(kernels._libs), dict(_build.COUNTS)
    odist, ocases = gk.classified_grid(other, *grid, parametric=True)
    opoints = pk.evaluate_points(other, pos, cuda_device, parametric=True)
    assert len(kernels._libs) == libs and dict(_build.COUNTS) == counts  # the same two libraries
    oref_dist, oref_cases = gk.classified_grid_plain(other, *grid)
    tol = 1e-5 * oref_dist.abs().clamp(min=1.0)
    assert bool(((odist - oref_dist).abs() <= tol).all())
    assert torch.equal(ocases, oref_cases)
    assert torch.equal(opoints.reshape(odist.shape), odist)
    assert not torch.equal(odist, dist)


def test_parametric_pointer_form_equals_by_value(cuda_device, monkeypatch):
    """A vector past the by-value limit is uploaded and read through a
    pointer: the same distances and cases, a library of its own."""
    tree = flagships.build_showerhead()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    args = (tree, fr.origin, fr.res, fr.shape(), cuda_device, 0, True)
    dist, cases = gk.classified_grid(*args)
    by_value = kernels.build(tree, "classified", True)
    assert by_value.gsdf_params_by_value() == 1
    monkeypatch.setattr(kernels, "PARAMS_BY_VALUE", False)
    by_pointer = kernels.build(tree, "classified", True)
    assert by_pointer is not by_value and by_pointer.gsdf_params_by_value() == 0
    pdist, pcases = gk.classified_grid(*args)
    assert torch.equal(pdist, dist) and torch.equal(pcases, cases)
    pos = gk.grid_positions(*args[1:5]).reshape(-1, 3).contiguous()
    assert torch.equal(pk.evaluate_points(tree, pos, cuda_device, True).reshape(dist.shape), dist)


def test_parametric_2d_tree_on_card(cuda_device):
    from gsdf_tpu_torch.eval.parametric import ParametricSDF2

    b = Builder()
    t1 = b.annulus(b.union2d(b.new_circle(0.5), b.new_rectangle(0.8, 0.3)), 0.1)
    t2 = b.annulus(b.union2d(b.new_circle(0.4), b.new_rectangle(0.5, 0.6)), 0.15)
    psdf = ParametricSDF2(t1)  # the card, unasked
    assert psdf.device == cuda_device
    pts = np.random.default_rng(2).uniform(-1, 1, (4096, 2)).astype(np.float32)
    before = kernels.LAUNCHES["point_eval_param"]
    d1, d2 = psdf.evaluate(pts), psdf.evaluate(pts, t2)
    assert kernels.LAUNCHES["point_eval_param"] == before + 2
    pos = torch.from_numpy(pts).to(cuda_device)
    for got, tree in ((d1, t1), (d2, t2)):
        np.testing.assert_allclose(got, pk.point_eval_plain(tree, pos).cpu().numpy(),
                                   rtol=0, atol=1e-5)


def _boss_part():
    b = Builder()
    hole = b.new_cylinder(0.25, 4.0, 0.0)
    body = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), b.new_cylinder(0.45, 1.2, 0.05))
    part = with_bounds(b.difference(body, hole), Box([-1.2, -0.8, -0.9], [1.2, 0.8, 0.9]))
    return part, body.s2


@pytest.mark.parametrize("path", ["render_compact", "render_indexed"])
def test_edit_loop_builds_nothing(path, cuda_device):
    """Three rebinds through one renderer: both counters (compiler runs,
    libraries loaded) stay where the first parametric render left them, no
    baked K1 is launched, and each mesh equals the baked render of the
    edited tree."""
    part, cyl = _boss_part()
    fr = FlatRenderer(part, 0.02, cuda_device)
    _, first = getattr(fr, path)(parametric=True)
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    sizes = [len(first)]
    for r in (0.35, 0.5, 0.4):
        part.rebind({cyl: {"r": r}})
        baked_before = kernels.LAUNCHES["classified_grid"]
        verts, tri = getattr(fr, path)(parametric=True)
        assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs
        assert kernels.LAUNCHES["classified_grid"] == baked_before
        sizes.append(len(tri))
        bverts, btri = getattr(FlatRenderer(part, 0.02, cuda_device), path)()
        assert np.array_equal(tri, btri) and np.array_equal(verts, bverts)
        counts, libs = dict(_build.COUNTS), len(kernels._libs)  # the baked render built one
    assert len(set(sizes)) == len(sizes)


def test_parametric_does_not_fall_back_when_the_build_fails(cuda_device, monkeypatch):
    """parametric=True with a failing compiler raises: no baked library is
    built or launched instead, and nothing runs on the CPU."""
    b = Builder()
    tree = b.smooth_union(0.13, b.new_sphere(0.61), b.translate(b.new_box(0.7, 0.5, 0.3, 0.02),
                                                               0.2, 0.1, 0.0))
    monkeypatch.setattr(kernels, "nvcc", lambda: "/bin/false")
    before = dict(kernels.LAUNCHES)
    fr = FlatRenderer(tree, 0.05, cuda_device)
    for render in (fr.render_compact, fr.render_indexed):
        with pytest.raises(RuntimeError, match="building gsdf_tree failed"):
            render(parametric=True)
    from gsdf_tpu_torch.eval.parametric import ParametricSDF3

    with pytest.raises(RuntimeError, match="building gsdf_tree failed"):
        ParametricSDF3(tree).evaluate(np.zeros((4, 3), np.float32))
    assert dict(kernels.LAUNCHES) == before


def test_parametric_launch_checks_the_vector_length(cuda_device):
    tree = Builder().new_sphere(1.0)
    lib = kernels.build(tree, "point", True)
    pos = torch.zeros((4, 3), device=cuda_device)
    out = torch.empty(4, device=cuda_device)
    p = np.ones(2, np.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.launch("point_eval_param", cuda_device, lib.gsdf_point_eval_param,
                       pos.data_ptr(), 4, out.data_ptr(), p.ctypes.data, 2)


# --- K5 / K5p: dual contouring -------------------------------------------
def _dc_case(name, cuda_device, resdiv=64, chiseled=False):
    from gsdf_tpu_torch.render.dual_contour import DualContourLeastSquares, DualContourRenderer

    tree = TREES[name]()
    c = DualContourLeastSquares(chiseled)
    dc = DualContourRenderer(tree, tree.bounds().diagonal() / resdiv, c, device=cuda_device)
    return tree, dc, c


def _dc_against_plain(tree, dc, c, cuda_device, shape, k0=0, n_own=None, parametric=False):
    """K5 (K5p) through its wrapper against dc_mesh_plain: edge ids, flips
    and the live-voxel count exact, vertices within 1e-4 * res (measured
    0); the grid pass (from a call of its own) equal to K2's in every
    float. Returns the kernel's edge ids and vertices."""
    from gsdf_tpu_torch.ops import dc_emit

    name = "dc_mesh_param" if parametric else "dc_mesh"
    before = kernels.LAUNCHES[name]
    mesh = dc_emit.dc_mesh(tree, dc.origin, dc.res, shape, cuda_device, c.norm_step,
                           c.sqrt_lambda, k0, n_own, parametric)
    assert kernels.LAUNCHES[name] == before + 1
    grid = dc_emit._launch_k5(tree, dc.origin, dc.res, shape, cuda_device, n_own, k0,
                              parametric, *dc_emit.qef_constants(c.norm_step, c.sqrt_lambda),
                              False, True)[-1]
    ref = dc_emit.dc_mesh_plain(tree, dc.origin, dc.res, shape, cuda_device, c.norm_step,
                                c.sqrt_lambda, k0, n_own)
    k2 = gk.evaluate_grid(tree, dc.origin, dc.res, shape, cuda_device, k0)
    torch.cuda.synchronize()
    assert torch.equal(mesh.eids, ref.eids) and torch.equal(mesh.flips, ref.flips)
    assert mesh.verts.shape == ref.verts.shape
    if len(mesh.verts):
        assert float((mesh.verts - ref.verts).abs().max()) <= 1e-4 * float(dc.res)
    assert torch.equal(grid, k2)
    return mesh.eids, mesh.verts


@pytest.mark.parametrize("chiseled", [False, True])
@pytest.mark.parametrize("name", list(TREES))
def test_dc_kernels_match_plain(name, chiseled, cuda_device):
    """K5 and K5p on every tree, both modes, against the plain version."""
    tree, dc, c = _dc_case(name, cuda_device, chiseled=chiseled)
    e, v = _dc_against_plain(tree, dc, c, cuda_device, dc.shape())
    ep, vp = _dc_against_plain(tree, dc, c, cuda_device, dc.shape(), parametric=True)
    assert len(e) > 100 and torch.equal(e, ep) and torch.equal(v, vp)


@pytest.mark.parametrize("chiseled", [False, True])
@pytest.mark.parametrize("name,resdiv", [(n, 64) for n in TREES] + [("bolt", 256)])
def test_dc_edges_match_plain(name, resdiv, chiseled, cuda_device):
    """K5's edge form (dc_edges: what the host_qef=True render reads, t
    and the raw normals) against dc_edges_plain, every value exact."""
    from gsdf_tpu_torch.ops import dc_emit

    tree, dc, c = _dc_case(name, cuda_device, resdiv, chiseled)
    before = kernels.LAUNCHES["dc_mesh"]
    e = dc_emit.dc_edges(tree, dc.origin, dc.res, dc.shape(), cuda_device, c.norm_step)
    assert kernels.LAUNCHES["dc_mesh"] == before + 1
    ref = dc_emit.dc_edges_plain(tree, dc.origin, dc.res, dc.shape(), cuda_device, c.norm_step)
    assert len(e.eids) > 100
    for got, want in zip(e, ref):
        assert torch.equal(got, want)


def test_dc_kernel_on_a_slab(cuda_device):
    """A slab at k0 != 0 whose top edge layer is a halo (n_own < layers)."""
    tree, dc, c = _dc_case("solid", cuda_device, resdiv=80)
    nk, nj, ni = dc.shape()
    k0, own = nk // 2 - 3, 5
    for parametric in (False, True):
        e, v = _dc_against_plain(tree, dc, c, cuda_device, (own + 2, nj, ni), k0, own,
                                 parametric)
        assert len(e) > 100 and len(v) > 100


def test_dc_reads_counts_once(cuda_device):
    """Up to its fetch a DC render synchronises once: K5's count read."""
    from gsdf_tpu_torch.ops import dc_emit

    tree, dc, c = _dc_case("bolt", cuda_device, resdiv=128)
    dc.render()  # builds the kernel
    torch.cuda.synchronize()
    _, syncs = _synchronising(lambda: dc_emit.dc_mesh(
        tree, dc.origin, dc.res, dc.shape(), cuda_device, c.norm_step, c.sqrt_lambda))
    assert len(syncs) == 1, syncs


@pytest.mark.parametrize("resdiv,golden", [(256, 99_844), (384, 226_340), (512, 403_104)])
def test_dc_bolt_goldens_on_card(resdiv, golden, cuda_device):
    """The bolt through K5: the JAX package's goldens, resdiv 512 on the
    chunk route, the host oracle at 256."""
    from gsdf_tpu_torch.render.dual_contour import DualContourRenderer

    bolt = flagships.build_bolt()
    res = bolt.bounds().diagonal() / resdiv
    dc = DualContourRenderer(bolt, res, device=cuda_device)
    chunked = dc.nx * dc.ny * dc.nz > dc.mono_voxels
    assert chunked == (resdiv == 512)
    before = kernels.LAUNCHES["dc_mesh"]
    tris = dc.render()
    assert len(tris) == golden
    assert kernels.LAUNCHES["dc_mesh"] > before
    if resdiv == 256:
        assert len(DualContourRenderer(bolt, res, device=cuda_device, host_qef=True).render()) \
            == golden


def test_dc_edit_loop_builds_nothing(cuda_device):
    """Three rebinds through K5p: no compiler run, no library loaded, each
    mesh equal to the baked render of the edited tree within 1e-6."""
    from gsdf_tpu_torch.render.dual_contour import DualContourRenderer

    part, cyl = _boss_part()
    first = DualContourRenderer(part, 0.03, device=cuda_device).render(parametric=True)
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    sizes = [len(first)]
    for r in (0.35, 0.5, 0.4):
        part.rebind({cyl: {"r": r}})
        tris = DualContourRenderer(part, 0.03, device=cuda_device).render(parametric=True)
        assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs
        baked = DualContourRenderer(part, 0.03, device=cuda_device).render()
        assert tris.shape == baked.shape
        np.testing.assert_allclose(tris, baked, rtol=0, atol=1e-6)
        sizes.append(len(tris))
        counts, libs = dict(_build.COUNTS), len(kernels._libs)  # the baked render built one
    assert len(set(sizes)) == len(sizes)


# --- K6c / K6a / the id map / K7s tile mode: the pruned renderer ---------
def _kept_tiles(keep, device):
    rows = np.argwhere(keep.cpu().numpy())[:, ::-1]
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(device)


@pytest.mark.parametrize("S", [8, 7])
@pytest.mark.parametrize("name", list(TREES))
def test_pruned_kernels_match_plain(name, S, cuda_device):
    """K6c and K6a, baked and parametric, the id map and K7s's tile mode
    against their plain versions: keep masks, counts, case bytes, ids and
    the soup exact, atlas distances within 1e-5 * max(1, |d|); the atlas
    equal to K1's grid at the same corners bit for bit."""
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    tree = TREES[name]()
    pr = PrunedRenderer(tree, tree.bounds().diagonal() / 64, tile_size=S, device=cuda_device)
    shape, dims, grid = (pr.tz, pr.ty, pr.tx), pr.dims(), (pr.origin, pr.res, S)
    fr = FlatRenderer(tree, pr.res, cuda_device)
    d1, _ = gk.classified_grid(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    pkeep, pcount = gk.coarse_keep_plain(tree, *grid, shape, cuda_device)
    tiles = _kept_tiles(pkeep, cuda_device)
    assert len(tiles) > 0
    pdist, pcases = gk.tile_grid_plain(tree, tiles, *grid, dims, cuda_device)
    for parametric in (False, True):
        before = dict(kernels.LAUNCHES)
        keep, count = gk.coarse_keep(tree, *grid, shape, cuda_device, parametric)
        dist, cases = gk.tile_grid(tree, tiles, *grid, dims, cuda_device, parametric)
        torch.cuda.synchronize()
        suffix = "_param" if parametric else ""
        assert kernels.LAUNCHES["tile_prune" + suffix] == before["tile_prune" + suffix] + 1
        assert kernels.LAUNCHES["tile_atlas" + suffix] == before["tile_atlas" + suffix] + 1
        assert torch.equal(keep, pkeep) and int(count) == int(pcount) == len(tiles)
        mask, n_keep = gk.keep_to_host(keep, count)  # the renderer's one copy
        assert np.array_equal(mask, pkeep.cpu().numpy()) and n_keep == len(tiles)
        assert torch.equal(cases, pcases)
        tol = 1e-5 * pdist.abs().clamp(min=1.0)
        assert bool(((dist - pdist).abs() <= tol).all())
        P = S + 1
        t = tiles.long()
        loc = torch.arange(P, device=cuda_device)
        gi, gj, gk_ = (t[:, c, None] * S + loc for c in range(3))
        nk, nj, ni = d1.shape
        inside = ((gk_ < nk)[:, :, None, None] & (gj < nj)[:, None, :, None]
                  & (gi < ni)[:, None, None, :])
        lin = (gk_.clamp(max=nk - 1)[:, :, None, None] * nj
               + gj.clamp(max=nj - 1)[:, None, :, None]) * ni + gi.clamp(max=ni - 1)[:, None, None, :]
        assert not bool(((dist.view(-1, P, P, P) != d1.reshape(-1)[lin]) & inside).any())
    comp = mc_emit.compact_active(cases)
    ids = compact_field.tile_global_ids(comp.ids, tiles, S, dims)
    assert torch.equal(ids, compact_field.tile_global_ids_plain(comp.ids, tiles, S, dims))
    tris = mc_emit.emit_triangles(dist, cases, comp.ids, pr.origin, pr.res, 0, comp.n_tris,
                                  comp.tri_offsets, tiles=tiles)
    assert torch.equal(tris, mc_emit.emit_triangles_plain(dist, cases, comp.ids, pr.origin,
                                                          pr.res, 0, tiles))
    assert len(tris) > 100


def test_emit_soup_dense_mode_unchanged(cuda_device):
    """K7s with no tile table is the dense kernel: equal to plain; and a
    one-tile atlas at tile (0, 0, 0) in tile mode places every triangle
    where the dense mode places it, bit for bit."""
    tree = _solid()
    origin, res = _centred((33, 33, 33))
    dist, cases = gk.classified_grid(tree, origin, res, (33, 33, 33), cuda_device)
    comp = mc_emit.compact_active(cases)
    dense = mc_emit.emit_triangles(dist, cases, comp.ids, origin, res, 0, comp.n_tris,
                                   comp.tri_offsets)
    assert torch.equal(dense, mc_emit.emit_triangles_plain(dist, cases, comp.ids, origin, res))
    one = torch.zeros((1, 3), dtype=torch.int32, device=cuda_device)
    tiled = mc_emit.emit_triangles(dist, cases, comp.ids, origin, res, 0, comp.n_tris,
                                   comp.tri_offsets, tiles=one)
    assert torch.equal(tiled, dense) and len(dense) > 1000


@pytest.mark.parametrize("name", ["solid", "flange", "bolt", "showerhead"])
def test_pruned_payload_equals_dense_on_card(name, cuda_device):
    """PrunedRenderer.compact_payload == the dense compact_field_render
    payload (ids, cases, t) on the card; one K6c, and one K6a, K3, id map
    and K4 a batch."""
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    tree = TREES[name]()
    res = tree.bounds().diagonal() / 150
    pr = PrunedRenderer(tree, res, tiles_per_batch=256, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    payload = pr.compact_payload()
    got = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}
    assert pr.batches > 1
    assert got == {"tile_prune": 1, **{k: pr.batches for k in (
        "tile_atlas", "compact_active", "tile_global_ids", "compact_emit")}}
    fr = FlatRenderer(tree, res, cuda_device)
    dense = compact_field.compact_field_render(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    for a, b in zip(payload, dense):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pruned_renders_on_card(cuda_device):
    """The flange's golden through the pruned compact path; render() the
    flat soup as sorted rows; the parametric edit loop with no build."""
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    tree = flagships.build_flange()
    res = tree.bounds().diagonal() / 400
    verts, tri = PrunedRenderer(tree, res).render_compact()
    assert len(tri) == flagships.GOLDEN_FLANGE_TRIS and tri.max() < len(verts)
    small = tree.bounds().diagonal() / 150

    def rows(t):
        r = np.ascontiguousarray(t.reshape(-1, 9))
        return r[np.lexsort(r.T[::-1])]

    soup = PrunedRenderer(tree, small, device=cuda_device).render()
    assert np.array_equal(rows(soup), rows(FlatRenderer(tree, small, cuda_device).render()))
    pinned, cyl = _boss_part()
    pr = PrunedRenderer(pinned, 0.02, device=cuda_device)
    pr.render_compact(parametric=True)
    FlatRenderer(pinned, 0.02, cuda_device).render_compact(parametric=True)
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    for r in (0.35, 0.5):
        pinned.rebind({cyl: {"r": r}})
        verts, tri = pr.render_compact(parametric=True)
        dverts, dtri = FlatRenderer(pinned, 0.02, cuda_device).render_compact(parametric=True)
        assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs
        assert np.array_equal(tri, dtri) and np.array_equal(verts, dverts)


# --- the raymarcher: K8 and K8p ------------------------------------------
def _frame_args(tree, w, h, aa, steps, device):
    from gsdf_tpu_torch.visual import raymarch as vrm

    return (vrm.camera(tree, 0.6, 0.5, 2.4), w, h, steps, vrm.auto_relax(tree), aa, device)


@pytest.mark.parametrize("aa", [1, 2])
@pytest.mark.parametrize("name", list(TREES))
def test_raymarch_matches_plain(name, aa, cuda_device):
    """K8 and K8p against raymarch_plain at 64 x 48 (196 steps): every
    pixel and every ray's evaluation count equal (both built without
    multiply-add contraction, the same host camera, CUDA's functions in
    both); K8p equal to K8; then the same K8p library with a structurally
    equal tree's values, against that tree's plain version."""
    from gsdf_tpu_torch.eval import ray_kernels as rk

    tree = TREES[name]()
    args = _frame_args(tree, 64, 48, aa, 196, cuda_device)
    before = dict(kernels.LAUNCHES)
    img, evals = rk.raymarch(tree, *args, evals=True)
    pimg, pevals = rk.raymarch(tree, *args, parametric=True, evals=True)
    assert kernels.LAUNCHES["raymarch"] == before["raymarch"] + 1
    assert kernels.LAUNCHES["raymarch_param"] == before["raymarch_param"] + 1
    ref, ref_evals = rk.raymarch_plain(tree, *args, evals=True)
    torch.cuda.synchronize()
    assert img.shape == (48, 64, 3) and img.dtype == torch.uint8 and img.device == cuda_device
    assert torch.equal(img, ref) and torch.equal(evals, ref_evals)
    assert torch.equal(pimg, img) and torch.equal(pevals, evals)
    other = _perturbed(tree)
    libs, counts = len(kernels._libs), dict(_build.COUNTS)
    oargs = _frame_args(other, 64, 48, aa, 196, cuda_device)
    oimg = rk.raymarch(other, *oargs, parametric=True)
    assert len(kernels._libs) == libs and dict(_build.COUNTS) == counts  # the same library
    assert torch.equal(oimg, rk.raymarch_plain(other, *oargs))


def test_raymarch_short_circuits(cuda_device):
    """The showerhead's code returns a Difference's minuend where its
    subtrahend cannot change the result: the 131 hole cylinders (above
    0.8) and the buttress screw (above 2.75), two sites; and skips a union
    member, a Cylinder, whose point bound the members run before it
    undercut: the knurled head's body, and past the holes' site the hole
    union's own member. At the viewer's
    rest frame (512 x 512, aa 3) K8, with and without its evaluation
    counts, and its counting form (count_short_circuits) equal the plain
    version in every pixel and every ray's evaluation count; every
    evaluation reaches the first three sites, and the counter reads skips
    at each of the four, by lane and by whole warp turn, while K8 itself
    counts nothing. The GEB
    sculpture's union skips the half whose point bound the other half's
    value undercuts: the half with the lower bound runs first, so each
    evaluation reaches one of the two union sites, and each reads skips
    by lane and by warp turn; all three forms equal plain there too. A
    sphere has no site: its code and its K8 are as before, and nothing is
    counted."""
    from gsdf_tpu_torch.eval import ray_kernels as rk

    tree = flagships.build_showerhead()
    args = _frame_args(tree, 512, 512, 3, 196, cuda_device)
    rk.SHORT_CIRCUITS.clear()
    img = rk.raymarch(tree, *args)
    eimg, eevals = rk.raymarch(tree, *args, evals=True)
    torch.cuda.synchronize()
    assert rk.SHORT_CIRCUITS == {}
    cimg, evals = rk.count_short_circuits(tree, *args)
    ref, ref_evals = rk.raymarch_plain(tree, *args, evals=True)
    torch.cuda.synchronize()
    assert torch.equal(img, ref) and torch.equal(eimg, ref) and torch.equal(cimg, ref)
    assert torch.equal(eevals, ref_evals) and torch.equal(evals, ref_evals)
    sites = rk.sites(tree)
    differences = [sub for _, sub, lo in sites if lo is not None]
    assert differences == ["screwnode_80e066040afe", "opunion_47f303063cec"]
    assert [sub for _, sub, lo in sites if lo is None] == ["cylinder_fa0113ce8a56",
                                                           "cylinder_42103e6013b8"]
    assert set(rk.SHORT_CIRCUITS) == {site for site, _, _ in sites + rk.loops(tree)}
    for site, sub, lo in sites:
        c = rk.SHORT_CIRCUITS[site]
        if sub != "cylinder_42103e6013b8":  # the hole union's own member: past its site
            assert c["lanes"] == int(evals.sum()), site
        assert 0 < c["lanes"] and 0 < c["lane_skips"] < c["lanes"], (site, c)
        assert 0 < c["turn_skips"] < c["turns"], (site, c)

    geb = flagships.build_geb()
    gargs = _frame_args(geb, 512, 512, 3, 196, cuda_device)
    rk.SHORT_CIRCUITS.clear()
    img = rk.raymarch(geb, *gargs)
    eimg, eevals = rk.raymarch(geb, *gargs, evals=True)
    torch.cuda.synchronize()
    assert rk.SHORT_CIRCUITS == {}
    cimg, evals = rk.count_short_circuits(geb, *gargs)
    ref, ref_evals = rk.raymarch_plain(geb, *gargs, evals=True)
    torch.cuda.synchronize()
    assert torch.equal(img, ref) and torch.equal(eimg, ref) and torch.equal(cimg, ref)
    assert torch.equal(eevals, ref_evals) and torch.equal(evals, ref_evals)
    sites = rk.sites(geb)
    assert len(sites) == 2 and all(lo is None for _, _, lo in sites)
    assert set(rk.SHORT_CIRCUITS) == {site for site, _, _ in sites}
    assert sum(c["lanes"] for c in rk.SHORT_CIRCUITS.values()) == int(evals.sum())
    for site, c in rk.SHORT_CIRCUITS.items():
        assert c["bound"] == "point" and c["member"] in site, (site, c)
        assert 0 < c["lane_skips"] < c["lanes"] and 0 < c["turn_skips"] < c["turns"], (site, c)

    sphere = Builder().new_sphere(1.0)
    assert rk.sites(sphere) == []
    rk.SHORT_CIRCUITS.clear()
    sargs = _frame_args(sphere, 64, 48, 1, 196, cuda_device)
    simg, sevals = rk.count_short_circuits(sphere, *sargs)
    sref, sref_evals = rk.raymarch_plain(sphere, *sargs, evals=True)
    assert torch.equal(simg, sref) and torch.equal(sevals, sref_evals)
    assert rk.SHORT_CIRCUITS == {}


def test_raymarch_loop_walks(cuda_device):
    """The showerhead's hole loop walks only the holes that its bin table
    lists for the point's xy cell: at the viewer's rest frame (512 x 512,
    aa 3) the counting form equals plain, lanes enter the loop, and the
    members walked a lane entry and a warp turn are at most the table's
    longest list (130 before the table); a warp turn walks at least what
    its average lane walks."""
    from gsdf_tpu_torch.codegen.cuda import bin_table
    from gsdf_tpu_torch.eval import ray_kernels as rk

    tree = flagships.build_showerhead()
    plate = tree.joined[1]
    (member, offsets), = plate.s2._groups()[0]
    table = bin_table(offsets[:, :2], member.axis_reach(-np.float32(plate.s1.lower_bound())))
    longest = int(np.diff(table.starts).max())
    args = _frame_args(tree, 512, 512, 3, 196, cuda_device)
    rk.SHORT_CIRCUITS.clear()
    cimg, evals = rk.count_short_circuits(tree, *args)
    ref, ref_evals = rk.raymarch_plain(tree, *args, evals=True)
    assert torch.equal(cimg, ref) and torch.equal(evals, ref_evals)
    (loop, _, n), = rk.loops(tree)
    assert n == len(offsets) == 130
    c = rk.SHORT_CIRCUITS[loop]
    share = rk.short_circuit_shares()[loop]
    assert 0 < c["entries"] < int(evals.sum()) and 0 < c["turns"], c
    assert 0 < share["lane_members"] <= share["warp_members"] <= longest < n, (share, longest)


def test_raymarch_edge_divisions(cuda_device):
    """A polygon's edge loop divides only where 0 < num < ee. On an
    extruded polygon, a tree with no site, K8 and the plain version march
    the same evaluations: the counting form equals plain in every pixel and
    evaluation count, and its EDGE_DIVISIONS lane counts equal a recount
    from the plain's own evaluations (each runs every edge; those with 0 <
    num < ee divide, num in the plain's float32 operations). The warp
    counts bound the lanes', and K8 itself counts nothing."""
    from gsdf_tpu_torch.eval import ray_kernels as rk

    a = np.linspace(0, 2 * np.pi, 13)[:-1]
    r = 1.0 + 0.3 * np.cos(3 * a)
    poly = Builder().new_polygon(np.stack([r * np.cos(a), r * np.sin(a)], axis=1))
    tree = Builder().extrude(poly, 0.8)
    assert rk.sites(tree) == [] and rk.loops(tree) == []
    (fn, n), = rk.polygons(tree)
    args = _frame_args(tree, 64, 48, 1, 196, cuda_device)
    rk.EDGE_DIVISIONS.clear()
    rk.raymarch(tree, *args, evals=True)
    torch.cuda.synchronize()
    assert rk.EDGE_DIVISIONS == {}
    cimg, evals = rk.count_short_circuits(tree, *args)
    seen, distance = [], poly.distance
    poly.distance = lambda p: (seen.append(p.cpu().numpy()), distance(p))[1]
    try:
        ref, ref_evals = rk.raymarch_plain(tree, *args, evals=True)
    finally:
        del poly.distance
    assert torch.equal(cimg, ref) and torch.equal(evals, ref_evals)
    p = np.concatenate(seen)
    assert len(p) == int(evals.sum())
    v1x, v1y, v2x, v2y = (poly._edges()[:, i] for i in range(4))
    ex, ey = v2x - v1x, v2y - v1y
    ee = ex * ex + ey * ey
    num = (p[:, :1] - v1x) * ex + (p[:, 1:2] - v1y) * ey
    c = rk.EDGE_DIVISIONS[fn]
    assert c["edges"] == n == len(ex)
    assert c["lanes"] == n * len(p)
    assert c["lane_divisions"] == int(((num > 0) & (num < ee)).sum())
    assert 0 < c["lane_divisions"] < c["lanes"] <= 32 * c["turns"]
    assert 0 < c["turn_divisions"] <= c["lane_divisions"] <= 32 * c["turn_divisions"]
    assert c["turn_divisions"] < c["turns"]
    share = rk.edge_division_shares()[fn]
    assert 0 < share["lane_share"] < 1 and 0 < share["warp_share"] < 1, share


def test_raymarch_one_library_per_tree(cuda_device):
    """Frame size, steps, relaxation and aa are launch arguments: after the
    first frame no size, step count or aa builds or loads a library, and
    each frame equals the plain version's."""
    from gsdf_tpu_torch.eval import ray_kernels as rk

    tree = _solid()
    rk.raymarch(tree, *_frame_args(tree, 8, 8, 1, 4, cuda_device))
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    for w, h, aa, steps in ((16, 16, 1, 5), (33, 17, 3, 200), (7, 40, 2, 0), (64, 64, 1, 72)):
        args = _frame_args(tree, w, h, aa, steps, cuda_device)
        img = rk.raymarch(tree, *args)
        assert torch.equal(img, rk.raymarch_plain(tree, *args))
    assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs


def test_raymarch_launch_rejects_what_the_kernel_does_not_take(cuda_device):
    tree = _solid()
    lib = kernels.build(tree, "raymarch")
    cam = _frame_args(tree, 4, 4, 1, 4, cuda_device)[0]
    buf = torch.empty((8, 8, 3), dtype=torch.uint8, device=cuda_device)
    queue = torch.empty(1, dtype=torch.int32, device=cuda_device).data_ptr()
    for w, h, steps, aa, out, q in ((4, 4, 4, 2, buf, queue), (8, 8, -1, 1, buf, queue),
                                    (0, 8, 4, 1, buf, queue), (8, 8, 4, 1, buf, None)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.launch("raymarch", cuda_device, lib.gsdf_raymarch, buf.data_ptr(),
                           out.data_ptr(), None, q, cam.ctypes.data, w, h, steps, 0.8, aa)


def test_raymarch_entry_points_default_to_the_card(cuda_device):
    from gsdf_tpu_torch.visual import raymarch as vrm

    tree = _solid()
    dev_img = vrm.raymarch_image_device(tree, 32, 24, steps=32)
    assert dev_img.device == cuda_device and dev_img.shape == (24, 32, 3)
    img = vrm.raymarch_image(tree, 32, 24, steps=32)
    np.testing.assert_array_equal(img, dev_img.cpu().numpy())
    np.testing.assert_array_equal(img, vrm.raymarch_image(tree, 32, 24, steps=32, device="cpu"))


def test_geb_viewer_frames_match_plain(cuda_device):
    """The GEB sculpture (text glyphs extruded, non-uniformly scaled and
    intersected, a shared subtree under two parents) through the viewer's
    rest frame on the card at aa 3, and after a drag, equal to the same
    viewer's frames on the CPU in every pixel."""
    from gsdf_tpu_torch.pipeline import InteractiveViewer

    tree = flagships.build_geb()
    frames = {}
    for dev in (cuda_device, "cpu"):
        v = InteractiveViewer(tree, width=48, height=40, aa=3, steps=196, device=dev)
        frames[str(dev)] = [v.render_current("full")]
        v.on_press(0, 0)
        v.on_move(-17, 9)
        v.on_release()
        frames[str(dev)].append(v.render_current("full"))
    for a, b in zip(frames[str(cuda_device)], frames["cpu"]):
        np.testing.assert_array_equal(a, b)


def test_viewer_on_card_builds_nothing_after_the_first_frame(cuda_device):
    """The viewer's drag, rest and slider frames on the card: one K8p
    launch a frame, no compiler run and no library loaded after the first
    frame, each frame equal to the plain version's on the CPU."""
    from gsdf_tpu_torch.pipeline import InteractiveViewer

    b = Builder()
    boss = b.new_cylinder(0.45, 1.2, 0.05)
    obj = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), boss)
    v = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16,
                          params=[("boss r", boss, "r", 0.2, 0.6)])
    assert v.device == cuda_device
    v.render_current("full")
    counts, before = dict(_build.COUNTS), dict(kernels.LAUNCHES)
    cpu = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16,
                            params=v.params, device="cpu")
    v.on_press(5, 5)
    v.on_move(25, 9)
    frames = [v.render_current("drag")]
    v.set_param(boss, "r", 0.3)
    v.on_release()
    frames.append(v.render_current("full"))
    assert dict(_build.COUNTS) == counts
    assert kernels.LAUNCHES["raymarch_param"] == before["raymarch_param"] + 2
    assert kernels.LAUNCHES["raymarch"] == before["raymarch"]
    cpu.yaw, cpu.pitch = v.yaw, v.pitch
    np.testing.assert_array_equal(frames[1], cpu.render_current("full"))


def test_spans_of_a_frame_and_a_compact_render_on_card(cuda_device):
    """On the card each wrapper's C entry call is a `launch.<kernel>` span
    under the request's root, beside the CPU's spans (test_torch_spans.py),
    and the launch counts are what they are without spans."""
    from gsdf_tpu_torch import spans
    from gsdf_tpu_torch.pipeline import InteractiveViewer

    v = InteractiveViewer(_solid(), width=32, height=24, steps=32)
    v.render_current("full")
    fr = FlatRenderer(_solid(), 0.05, cuda_device)
    fr.render_compact()
    before = dict(kernels.LAUNCHES)
    spans.clear()
    with spans.recording():
        v.render_current("full")
        fr.render_compact()
    recs = spans.records()
    frame = next(r for r in recs if r.name == "viewer.frame")
    assert sorted(r.name for r in recs if r.parent == frame.seq) == [
        "launch.raymarch", "raymarch.scene", "viewer.fetch"]
    render = next(r for r in recs if r.name == "flat.render_compact")
    assert sorted(r.name for r in recs if r.parent == render.seq) == [
        "compact.fetch", "launch.classified_grid", "launch.compact_active",
        "launch.compact_emit", "mc.count_read", "native.decode"]
    moved = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}
    assert moved == {"raymarch": 1, "classified_grid": 1, "compact_active": 1, "compact_emit": 1}
    spans.clear()


def test_pipelined_drag_frames_on_card(cuda_device):
    """Drag pipelining on the card: frame N-1's copy is enqueued before
    frame N launches; each displayed frame equals the unpipelined viewer's
    frame of the view one event earlier."""
    from gsdf_tpu_torch.pipeline import InteractiveViewer

    obj = _solid()
    v = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16, pipeline=True)
    ref = InteractiveViewer(obj, width=64, height=64, steps=48, drag_steps=16)
    v.on_press(10, 10)
    views, shown = [], []
    for x in (20, 40, 60, 80):
        v.on_move(x, 12)
        views.append((v.yaw, v.pitch))
        shown.append(v.render_current("drag"))
    expect = []
    for yaw, pitch in views:
        ref.yaw, ref.pitch = yaw, pitch
        expect.append(ref.render_current("drag"))
    np.testing.assert_array_equal(shown[0], expect[0])
    for k in range(1, 4):
        np.testing.assert_array_equal(shown[k], expect[k - 1])
