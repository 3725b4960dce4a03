"""The port's pruned tile renderer against the JAX package's (CPU).

The analogs of tests/test_pruned.py, each through the port's
`PrunedRenderer` on the CPU (the plain versions of K6c, K6a, the id map
and K7s's tile mode) and through `gsdf_tpu`'s on the JAX CPU backend under
`jax.disable_jit()` (so that XLA-CPU's FMA contraction moves nothing).
The scenes are pinned (with_bounds) to one box and rendered at one
resolution (PIN, RES): 45^3 cubes, so tiles of 8 overhang the grid (48),
and the JAX side compiles its op-by-op primitives for one grid.

Tolerances: tile lists, evaluations(), total_pruned(), cube ids, case
bytes, triangle counts and connectivity exact; soups and the payload's t
bit-identical to the port's own dense path, and to the JAX package's on
the pinned scenes (measured 0); on random trees (the seeds of
tests/test_fuzz_paths.py::test_pruned_path_agrees) t within 1e-4 of a
voxel edge of the JAX package's, test_torch_fuzz.py's bound (an ulp of
sin, cos or atan2 amplified where an edge nearly cancels).

Also: a tile size that leaves the grid's edge tiles overhanging, a part
that keeps no tile, batches of one tile (kept tiles with no active cube),
the render_compact fallback on the cropped parts of test_torch_fuzz.py
(seeds 2 and 4), and the analog of tests/test_rebind.py:140 (an edited
parametric render equal to the dense one).
"""
import math

import jax
import numpy as np
import pytest
import torch
from test_fuzz_paths import _random_tree
from test_torch_fuzz import _cropped_tree

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.core.wrappers import with_bounds as jax_with_bounds
from gsdf_tpu.geometry import box3 as jax_box3
from gsdf_tpu.ops.compact_field import unpack_compact_payload_full_ids
from gsdf_tpu.render import pruned as jpruned
from gsdf_tpu.render.pruned import PrunedRenderer as JaxPrunedRenderer
from gsdf_tpu_torch import Builder
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.core.wrappers import with_bounds
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.geometry import box3
from gsdf_tpu_torch.geometry.boxes import Box
from gsdf_tpu_torch.ops import compact_field, mc_emit
from gsdf_tpu_torch.ops.compact_field import compact_field_render, tile_compact_emit
from gsdf_tpu_torch.render import PrunedRenderer, render_all
from gsdf_tpu_torch.render.flat import FlatRenderer

CPU = torch.device("cpu")
T_TOL = 1e-4  # of a voxel edge, on random trees


def _part(b):
    """test_pruned.py's part: its grid's edge tiles overhang."""
    return b.difference(
        b.smooth_union(0.1, b.new_sphere(0.8), b.new_box(1.2, 1.2, 0.5, 0.05)),
        b.new_cylinder(0.3, 4.0, 0.0),
    )


def _boss(b):
    """tests/test_rebind.py's part: (tree, its boss cylinder)."""
    hole = b.new_cylinder(0.25, 4.0, 0.0)
    body = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), b.new_cylinder(0.45, 1.2, 0.05))
    return b.difference(body, hole), body.s2


PIN = (-1.1, -1.1, -1.1, 1.1, 1.1, 1.1)
RES = 0.05
SCENES = {
    "part": _part,
    "sphere": lambda b: b.new_sphere(0.8),
    "smooth": lambda b: b.smooth_union(0.2, b.new_sphere(0.6), b.new_box(1.0, 0.7, 0.4, 0.0)),
    "boss": lambda b: _boss(b)[0],
}
TPB = 32  # tiles per batch: every scene runs in several batches
_jax = {}


def scene(name, jax_side=False):
    if jax_side:
        return jax_with_bounds(SCENES[name](JaxBuilder()), jax_box3(*PIN))
    return with_bounds(SCENES[name](Builder()), box3(*PIN))


def jax_run(name, what):
    """The JAX package's pruned renderer on a scene, op by op: its tile
    list, payload, soup batches and mesh, with evaluations() and
    total_pruned() after each."""
    key = (name, what)
    if key not in _jax:
        with jax.disable_jit():
            pr = JaxPrunedRenderer(scene(name, True), RES, tiles_per_batch=TPB,
                                   device=jax.devices("cpu")[0])
            out = {"tiles": pr._prune, "payload": pr.compact_payload,
                   "batches": lambda: list(pr.read_triangles()),
                   "mesh": pr.render_compact}[what]()
        _jax[key] = (out, pr.evaluations(), pr.total_pruned())
    return _jax[key]


def renderer(name, **kw):
    return PrunedRenderer(scene(name), RES, **{"tiles_per_batch": TPB, "device": CPU, **kw})


def dense_payload(tree, res):
    fr = FlatRenderer(tree, res, CPU)
    return compact_field_render(tree, fr.origin, fr.res, fr.shape(), CPU)


def _sorted_rows(tris):
    rows = np.ascontiguousarray(tris.reshape(-1, 9))
    return rows[np.lexsort(rows.T[::-1])]


def test_grid_is_pinned_and_overhangs():
    pr = renderer("part")
    assert (pr.nx, pr.ny, pr.nz) == (45, 45, 45) and (pr.tx, pr.ty, pr.tz) == (6, 6, 6)
    assert pr.device == CPU and (pr.S, pr.tiles_per_batch) == (8, TPB)


@pytest.mark.parametrize("name", ["part", "sphere", "smooth"])
def test_tile_list_and_counts_match_jax(name):
    """_prune's tiles ([i, j, k] rows in argwhere order), evaluations() and
    total_pruned() after a compact render, as the JAX package's."""
    pr = renderer(name)
    jtiles, jeval, jpruned_ = jax_run(name, "tiles")
    tiles = pr._prune()
    assert tiles.dtype == np.int32 and tiles.flags.c_contiguous
    np.testing.assert_array_equal(tiles, jtiles)
    assert (pr.evaluations(), pr.total_pruned()) == (jeval, jpruned_)
    assert pr.kept == len(tiles) < pr.tx * pr.ty * pr.tz
    _, jeval, jpruned_ = jax_run(name, "payload")
    pr = renderer(name)
    pr.compact_payload()
    assert (pr.evaluations(), pr.total_pruned()) == (jeval, jpruned_)
    assert pr.batches == -(-pr.kept // TPB) > 1


@pytest.mark.parametrize("name", ["part", "sphere", "smooth", "boss"])
def test_pruned_payload_equals_dense_and_jax(name):
    """test_pruned_compact_payload_matches_dense: the merged pruned payload
    is the dense compact payload exactly (ids, cases and t), and the JAX
    package's pruned payload (t measured bit-identical here too)."""
    ids, cases, t = renderer(name).compact_payload()
    for got, want in zip((ids, cases, t), dense_payload(scene(name), RES)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    (jids, jcases, jt), _, _ = jax_run(name, "payload")
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cases, jcases)
    np.testing.assert_array_equal(t, jt)
    assert len(ids) > 1000


def test_batch_payloads_match_jax_tile_compact_fn():
    """Each batch's (global ids, cases, t) in the JAX package's tile-major
    slot order: the port's tile_compact_emit on K6a's atlas against JAX's
    _tile_compact_fn on the same batch (padded to its bucket with -1 rows
    as its renderer pads it) and unpacked."""
    pr = renderer("part")
    tiles = pr._prune()
    a_size = v_size = 1 << 14
    for start in range(0, len(tiles), TPB):
        batch = tiles[start : start + TPB]
        padded = np.concatenate([batch, np.full((TPB - len(batch), 3), -1, np.int32)])
        with jax.disable_jit():
            fn = jpruned._tile_compact_fn(scene("part", True), 8, TPB, a_size, v_size,
                                          pr.dims(), jax.devices("cpu")[0])
            jids, jcases, jt, (na, nv) = unpack_compact_payload_full_ids(
                np.asarray(fn(padded, pr.origin, pr.res)), a_size)
        assert na <= a_size and nv <= v_size
        dist, cases = gk.tile_grid(pr.s, torch.from_numpy(batch), pr.origin, pr.res, 8,
                                   pr.dims(), CPU)
        assert dist.shape == (9 * len(batch), 9, 9) and cases.shape == (9 * len(batch) - 1, 8, 8)
        ids, idx8, t = tile_compact_emit(dist, cases, torch.from_numpy(batch), pr.dims())
        np.testing.assert_array_equal(ids.numpy().view(np.uint32), jids)
        np.testing.assert_array_equal(idx8.numpy(), jcases)
        np.testing.assert_array_equal(t.numpy(), jt)


@pytest.mark.parametrize("name", ["part", "sphere"])
def test_pruned_soup_matches_flat_and_jax_batches(name):
    """test_pruned_matches_flat and test_pruned_streaming: one batch of
    triangles per batch of tiles, each equal to the JAX package's batch
    row for row; all of them the flat soup as bit-identical sorted rows."""
    pr = renderer(name)
    batches = list(pr.read_triangles())
    jbatches, jeval, jpruned_ = jax_run(name, "batches")
    assert len(batches) == len(jbatches) == pr.batches == -(-pr.kept // TPB) > 1
    for got, want in zip(batches, jbatches):
        assert got.dtype == np.float32 and got.shape[1:] == (3, 3)
        np.testing.assert_array_equal(got, want)
    assert (pr.evaluations(), pr.total_pruned()) == (jeval, jpruned_)
    flat = FlatRenderer(scene(name), RES, CPU).render()
    np.testing.assert_array_equal(_sorted_rows(np.concatenate(batches)), _sorted_rows(flat))
    assert pr.total_pruned() > 0


def test_render_all_drains_the_stream():
    tris = render_all(renderer("sphere", tiles_per_batch=2048))
    assert len(tris) > 100
    np.testing.assert_array_equal(tris, np.concatenate(list(renderer("sphere").read_triangles())))


@pytest.mark.parametrize("name", ["part", "smooth"])
def test_pruned_render_compact_mesh(name):
    """test_pruned_render_compact_mesh: the dense compact path's mesh; the
    JAX package's pruned mesh with the same connectivity."""
    pr = renderer(name)
    verts, tri = pr.render_compact()
    dverts, dtri = FlatRenderer(scene(name), RES, CPU).render_compact()
    np.testing.assert_array_equal(tri, dtri)
    np.testing.assert_array_equal(verts, dverts)
    (jverts, jtri), _, _ = jax_run(name, "mesh")
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(verts, jverts)
    assert pr.fallbacks == 0 and len(tri) > 1000


@pytest.mark.parametrize("S", [6, 7, 16])
def test_overhanging_tile_sizes(S):
    """Tile sizes that do not divide the 45-cube grid: the cubes past it
    are masked, and payload and soup are the dense path's."""
    pr = renderer("part", tile_size=S)
    assert pr.tx * S > pr.nx
    for got, want in zip(pr.compact_payload(), dense_payload(scene("part"), RES)):
        np.testing.assert_array_equal(got, want)
    flat = FlatRenderer(scene("part"), RES, CPU).render()
    np.testing.assert_array_equal(_sorted_rows(renderer("part", tile_size=S).render()),
                                  _sorted_rows(flat))


def test_batches_of_one_tile():
    """A kept tile can hold no active cube: with one tile a batch, such
    batches are empty parts of the merge, which drops them."""
    pr = renderer("sphere", tiles_per_batch=1)
    payload = pr.compact_payload()
    assert pr.batches == pr.kept
    for got, want in zip(payload, dense_payload(scene("sphere"), RES)):
        np.testing.assert_array_equal(got, want)
    dist, cases = gk.tile_grid(pr.s, torch.from_numpy(pr._prune()), pr.origin, pr.res, 8,
                               pr.dims(), CPU)
    assert cases.shape[0] == 9 * pr.kept - 1
    empty = [t for t in range(pr.kept) if not bool(cases[9 * t : 9 * t + 8].any())]
    assert empty, "every kept tile holds an active cube: the case is not reached"


def test_part_that_keeps_no_tile():
    """A render box that the surface does not reach: no tile is kept, and
    every output is empty, as in the JAX package."""
    body = Builder().new_sphere(0.3)
    pr = PrunedRenderer(with_bounds(body, Box([2, 2, 2], [3, 3, 3])), 0.05, device=CPU)
    ids, cases, t = pr.compact_payload()
    assert (len(ids), len(cases), len(t), pr.kept, pr.batches) == (0, 0, 0, 0, 0)
    assert ids.dtype == np.uint32 and cases.dtype == np.uint8 and t.dtype == np.float32
    assert pr.total_pruned() == pr.tx * pr.ty * pr.tz * 9**3
    assert pr.evaluations() == pr.tx * pr.ty * pr.tz
    verts, tri = pr.render_compact()
    assert verts.shape == (0, 3) and tri.shape == (0, 3) and pr.fallbacks == 0
    assert pr.render().shape == (0, 3, 3) and list(pr.read_triangles()) == []
    with jax.disable_jit():
        jb = JaxBuilder()
        jpr = JaxPrunedRenderer(jax_with_bounds(jb.new_sphere(0.3), jax_box3(2, 2, 2, 3, 3, 3)),
                                0.05)
        jids, _, _ = jpr.compact_payload()
    assert len(jids) == 0 and jpr.total_pruned() == pr.tx * pr.ty * pr.tz * 9**3


def test_empty_bounds_rejected():
    """test_empty_bounds_tree_rejected_everywhere: the reference's loud
    error for an inverted bounds box; and the renderer's own arguments."""
    b = Builder()
    t = b.intersection(b.new_sphere(0.4), b.translate(b.new_sphere(0.4), 3.0, 0.0, 0.0))
    assert t.bounds().is_empty()
    with pytest.raises(ValueError, match="not fine enough"):
        PrunedRenderer(t, 0.05, device=CPU)
    with pytest.raises(ValueError, match="invalid renderer cube resolution"):
        PrunedRenderer(b.new_sphere(1.0), 0.0, device=CPU)
    with pytest.raises(ValueError, match="at least 1"):
        PrunedRenderer(b.new_sphere(1.0), 0.1, tile_size=0, device=CPU)


@pytest.mark.parametrize("seed", [2, 4])
def test_cropped_part_falls_back(seed):
    """test_torch_fuzz.py's cropped seeds: the decoder finds an owner past
    the grid, render_compact counts a fallback and returns the port's
    FlatRenderer.render_indexed() (the welded soup, which
    test_torch_fuzz.py::test_cropped_seed_falls_back holds to the JAX
    package's soup): the same mesh bit for bit, every index below V."""
    _, ttree, res = _cropped_tree(seed)
    pr = PrunedRenderer(ttree, res, tiles_per_batch=TPB, device=CPU)
    for got, want in zip(pr.compact_payload(), dense_payload(ttree, res)):
        np.testing.assert_array_equal(got, want)
    verts, tri = pr.render_compact()
    assert pr.fallbacks == 1
    fverts, ftri = FlatRenderer(ttree, res, CPU).render_indexed()
    np.testing.assert_array_equal(tri, ftri)
    np.testing.assert_array_equal(verts, fverts)
    assert len(tri) > 0 and tri.max() < len(verts)
    assert pr.evaluations() > pr.tx * pr.ty * pr.tz + math.prod(
        FlatRenderer(ttree, res, CPU).shape())  # the fallback's corners counted


@pytest.mark.parametrize("seed", range(3))
def test_random_tree_pruned_path_agrees(seed):
    """tests/test_fuzz_paths.py::test_pruned_path_agrees on the port: the
    pruned payload is the port's dense one exactly, and its ids and cases
    the JAX package's pruned payload's, t within 1e-4 of a voxel edge."""
    jtree = _random_tree(np.random.default_rng(200 + seed), lipschitz=True)
    if jtree is None:
        pytest.skip("builder rejected random combination")
    bbd = jtree.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or jtree.bounds().is_empty():
        pytest.skip("degenerate/empty bounds")
    ttree = from_reference_tree(jtree)
    res = bbd / 32
    ids, cases, t = PrunedRenderer(ttree, res, tiles_per_batch=128, device=CPU).compact_payload()
    for got, want in zip((ids, cases, t), dense_payload(ttree, res)):
        np.testing.assert_array_equal(got, want)
    with jax.disable_jit():
        jids, jcases, jt = JaxPrunedRenderer(jtree, res, tiles_per_batch=128).compact_payload()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cases, jcases)
    dt = np.abs(t.astype(np.float64) - jt.astype(np.float64))
    assert len(t) == len(jt) and dt.max(initial=0.0) <= T_TOL


def test_rebind_pruned_compact_equals_dense():
    """tests/test_rebind.py:140 on the port: an edit of the pinned part
    renders through the same (plain) path and equals the dense compact
    render of the edited tree, and the JAX package's pruned render of the
    same edit."""
    tree, cyl = _boss(Builder())
    pinned = with_bounds(tree, box3(*PIN))
    pr = PrunedRenderer(pinned, RES, tiles_per_batch=512, device=CPU)
    _, i0 = pr.render_compact(parametric=True)
    pinned.rebind({cyl: {"r": 0.35}})
    v1, i1 = pr.render_compact(parametric=True)
    assert len(i1) != len(i0)
    dv, di = FlatRenderer(pinned, RES, CPU).render_compact(parametric=True)
    np.testing.assert_array_equal(i1, di)
    np.testing.assert_array_equal(v1, dv)
    jtree, jcyl = _boss(JaxBuilder())
    jpinned = jax_with_bounds(jtree, jax_box3(*PIN))
    jpinned.rebind({jcyl: {"r": 0.35}})
    with jax.disable_jit():
        jv, ji = JaxPrunedRenderer(jpinned, RES, tiles_per_batch=TPB).render_compact()
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_allclose(v1, jv, rtol=0, atol=1e-6)


def test_kernel_plain_versions_on_an_atlas():
    """The id map and K7s's tile mode against the whole grid's: the atlas
    ids made global are the dense grid's active ids of those tiles, and
    the tile-mode soup of every kept tile is the dense soup (sorted)."""
    pr = renderer("part")
    tiles = torch.from_numpy(pr._prune())
    dist, cases = gk.tile_grid(pr.s, tiles, pr.origin, pr.res, 8, pr.dims(), CPU)
    comp = mc_emit.compact_active(cases)
    gids = compact_field.tile_global_ids(comp.ids, tiles, 8, pr.dims())
    fr = FlatRenderer(pr.s, RES, CPU)
    ddist, dcases = gk.classified_grid(pr.s, fr.origin, fr.res, fr.shape(), CPU)
    dense_ids = mc_emit.compact_indices(dcases)
    np.testing.assert_array_equal(np.sort(gids.numpy()), dense_ids.numpy())
    np.testing.assert_array_equal(cases.reshape(-1)[comp.ids.long()].numpy(),
                                  dcases.reshape(-1)[gids.long()].numpy())
    soup = mc_emit.emit_triangles(dist, cases, comp.ids, pr.origin, pr.res, 0, tiles=tiles)
    dense = mc_emit.emit_triangles(ddist, dcases, dense_ids, fr.origin, fr.res)
    np.testing.assert_array_equal(_sorted_rows(soup.numpy()), _sorted_rows(dense.numpy()))
    with pytest.raises(ValueError, match="tile mode"):
        mc_emit.emit_triangles(ddist, dcases, dense_ids, fr.origin, fr.res, 0, tiles=tiles)


def test_keep_mask_and_count_come_over_in_one_buffer():
    """keep_to_host reads K6c's layout, one int32 buffer holding the mask's
    bytes and then the count, as one copy; the plain version's two tensors
    as they are. Both give the coarse pass's mask and count."""
    pr = renderer("part")
    shape = (pr.tz, pr.ty, pr.tx)
    pkeep, pcount = gk.coarse_keep_plain(pr.s, pr.origin, pr.res, pr.S, shape, CPU)
    n = pkeep.numel()
    buf = torch.full((-(-n // 4) + 1,), -1, dtype=torch.int32)  # K6c's buffer
    keep, count = buf.view(torch.uint8)[:n].view(shape), buf[-1:]
    keep.copy_(pkeep)
    count.copy_(pcount)
    for k, c in ((keep, count), (pkeep, pcount)):
        mask, n_keep = gk.keep_to_host(k, c)
        assert mask.dtype == np.uint8 and mask.shape == shape
        np.testing.assert_array_equal(mask, pkeep.numpy())
        assert n_keep == int(pkeep.sum()) == pr._prune().shape[0] > 0


def test_knurled_prune_drops_what_the_jax_package_drops():
    """The knurled cylinder (two Twists: not 1-Lipschitz) at resdiv 350:
    the coarse test prunes two active cubes' tiles, so the pruned payload
    misses two of the dense payload's cubes (616,322 triangles against the
    golden 616,324). The JAX package's own PrunedRenderer, jitted on the
    CPU as its tests run it, misses the same two cubes of its own dense
    payload. (Jitted, XLA-CPU contracts multiply-adds, which moves ~0.5%
    of the near-zero case bytes of both its payloads against the port's,
    so the two are compared by what the prune drops. No resdiv from 40 to
    259 drops a cube at tiles of 8 or 16.)"""
    from gsdf_tpu import flagships as jax_flagships
    from gsdf_tpu.ops.compact_field import compact_field_render as jax_compact_field_render
    from gsdf_tpu_torch import flagships

    ttree, jtree = flagships.build_knurled(), jax_flagships.build_knurled()
    res = ttree.bounds().diagonal() / 350
    ids, cases, t = PrunedRenderer(ttree, res, device=CPU).compact_payload()
    dense = dense_payload(ttree, res)
    dropped = np.setdiff1d(dense[0], ids)
    np.testing.assert_array_equal(dropped, [477719, 485468])
    assert len(np.setdiff1d(ids, dense[0])) == 0
    jpr = JaxPrunedRenderer(jtree, res)
    jids = jpr.compact_payload()[0]
    jdense = jax_compact_field_render(jtree, jpr.origin, jpr.res,
                                      (jpr.nz + 1, jpr.ny + 1, jpr.nx + 1),
                                      jax.devices("cpu")[0])[0]
    np.testing.assert_array_equal(np.setdiff1d(jdense, jids), dropped)
    assert len(jids) == len(ids) and len(jdense) == len(dense[0])


def test_cropped_soup_keeps_to_the_grid():
    """On a surface that crosses the render box (cropped seed 2) the port's
    pruned soup is the flat soup: K6a's case grid masks the cubes of edge
    tiles past the global grid, for the soup as for the payload. The JAX
    package's pruned soup masks only padding tiles (render/pruned.py:162-
    163), so it also emits the surface past the grid: a fault of the
    reference, left there (ROADMAP.md section 3)."""
    from gsdf_tpu.render.flat import FlatRenderer as JaxFlatRenderer

    jtree, ttree, res = _cropped_tree(2)
    soup = PrunedRenderer(ttree, res, tiles_per_batch=TPB, device=CPU).render()
    flat = FlatRenderer(ttree, res, CPU).render()
    np.testing.assert_array_equal(_sorted_rows(soup), _sorted_rows(flat))
    jsoup = JaxPrunedRenderer(jtree, res).render()
    jflat = JaxFlatRenderer(jtree, res).render()
    assert len(jflat) == len(flat) < len(jsoup), "the reference's fault is gone: update this test"
