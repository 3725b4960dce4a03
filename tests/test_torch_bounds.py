"""The port's kernel bounds (bounds.py, beside chip_smoke.py) on the CPU: the
operation counter on trees whose count is known by hand, its linearity in
the number of points on the golden parts, and the byte and bound
arithmetic that chip_smoke.py prints beside each kernel's time."""
import numpy as np
import pytest
import torch

import bounds
from gsdf_tpu_torch import Builder, flagships
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.ops import mc_emit

#: sqrt(x*x + y*y + z*z) - r: 3 mul, 2 add, sqrt, sub
SPHERE_OPS = 7


def test_sphere_counts_by_hand():
    assert bounds.tree_ops_per_point(Builder().new_sphere(1.0)) == SPHERE_OPS


def test_two_child_union_counts_by_hand():
    """Two spheres and the min of their distances."""
    b = Builder()
    tree = b.union(b.new_sphere(1.0), b.new_sphere(0.5))
    assert bounds.tree_ops_per_point(tree) == 2 * SPHERE_OPS + 1


def test_translated_child_counts_its_offset():
    """A Translate subtracts its offset: 3 more operations."""
    b = Builder()
    tree = b.union(b.new_sphere(1.0), b.translate(b.new_sphere(0.5), 1.0, 0.0, 0.0))
    assert bounds.tree_ops_per_point(tree) == 2 * SPHERE_OPS + 3 + 1


@pytest.mark.parametrize("name", ["flange", "showerhead", "bolt", "knurled"])
def test_golden_part_counts_linear_in_points(name):
    tree = getattr(flagships, f"build_{name}")()
    per = bounds.tree_ops_per_point(tree, 100)
    assert per == bounds.tree_ops_per_point(tree, 1000, seed=1) > 100


def test_counter_skips_casts_views_indexing_and_integers():
    x = torch.rand(10, 3)
    _, ops = bounds.count_ops(lambda: (x.double().float()[:, 0], x[..., 1:].clone(),
                                       torch.arange(10) * 3, torch.stack([x, x])))
    assert ops == 0
    _, ops = bounds.count_ops(lambda: torch.amax(x, dim=-1) + torch.maximum(x, x).sum())
    assert ops == 10 * 2 + 30 + (30 - 1) + 10  # amax folds 2 of 3; sum folds 29 of 30


def test_classification_counts_ten_per_cube():
    """8 sign tests, |d0| and its compare; the case arithmetic is integer."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 6, 7)).astype(np.float32))
    _, ops = bounds.count_ops(mc_emit.effective_cases, g, np.float32(0.1))
    assert ops == 10 * 4 * 5 * 6


def test_kernel_bytes_and_bound():
    assert bounds.kernel_bytes("classified_grid", corners=1000, cubes=729) == 4729
    assert bounds.kernel_bytes("grid_eval", corners=1000) == 4000
    assert bounds.kernel_bytes("compact_active", cubes=4096, active=257) == 4096 + 4 * 257 + 32 + 24
    b = bounds.bound(ops=33.5e9, nbytes=1e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    assert b["published_fp32_ms"] == pytest.approx(0.5)
    b = bounds.bound(ops=0, nbytes=6.7e9)
    assert b["bound_ms"] == pytest.approx(2.0) and b["bound_by"] == "bytes"


def test_k1_plain_counts_tree_and_classification():
    """The plain K1 runs the tree's operations at every corner, the
    classification's at every cube, and 2 per index of each axis to make
    the positions (origin + index * res)."""
    tree = Builder().new_sphere(1.0)
    shape = (4, 5, 6)
    origin, res = np.float32([-1.2, -1.2, -1.2]), np.float32(0.4)
    _, ops = bounds.count_ops(gk.classified_grid_plain, tree, origin, res, shape, "cpu")
    assert ops == SPHERE_OPS * 4 * 5 * 6 + 10 * 3 * 4 * 5 + 2 * (4 + 5 + 6)


#: K5's floating-point work per active edge: t (eq, sub, where, div, neg)
#: and flip (sub, lt); the crossing point (3 mul, 3 add, then t * res added
#: on its axis); the six offset points (18 add/sub), the three differences
#: and their scaling (6)
DC_EDGE_OPS = 7 + 8 + 24
#: per row a voxel adds: q = (p - origin) / res - index (9), n (n . q) and
#: the upper triangle of n n^T (14), and the 13 sums
DC_ROW_OPS = 9 + 14 + 13
#: per live voxel: the bias point and shifted right-hand side (27), 15
#: Jacobi rotations of 50 operations each, the floored solve and clamp (53),
#: the vertex (12)
DC_VOXEL_OPS = 27 + 15 * 50 + 53 + 12


def test_dc_mesh_bytes_and_ops():
    """K5's bytes are its outputs; its plain version's operations are
    exactly K5's work: the tree at every corner and 6 times at every active
    edge, t, flip and the normal at every active edge, a row for each
    contribution that an active edge makes to an owned voxel, the solve
    at every live voxel. Nothing on inactive edges or absent rows."""
    from gsdf_tpu_torch.ops import dc_emit
    from gsdf_tpu_torch.ops.dc_tables import OFF5

    assert bounds.kernel_bytes("dc_mesh", edges=100, voxels=90) == 500 + 1080
    assert bounds.kernel_bytes("dc_mesh_param", edges=100, voxels=90, n_params=7) == 1636
    tree = Builder().new_sphere(1.0)
    origin, res = np.full(3, -1.3, np.float32), 0.25
    for shape, n_own in (((12, 12, 12), None), ((7, 12, 12), 5)):
        mesh, ops = bounds.count_ops(dc_emit.dc_mesh_plain, tree, origin, res, shape, "cpu",
                                     2e-8, 1e-3, 3, n_own)
        nk, nj, ni = shape
        nx, ny, own = ni - 1, nj - 1, n_own or nk - 1
        eid = mesh.eids.numpy().astype(np.int64)
        nvox = (nk - 1) * ny * nx
        ax, lin = eid // nvox, eid % nvox
        i, j, k = lin % nx, lin // nx % ny, lin // (nx * ny)
        rows = sum(int(((0 <= i + di) & (i + di < nx) & (0 <= j + dj) & (j + dj < ny)
                        & (0 <= k + dk) & (k + dk < own))[ax == a].sum())
                   for a in range(3) for di, dj, dk in OFF5[a])
        assert len(eid) > 50 and rows > 4 * len(eid) // 2
        assert ops == (SPHERE_OPS * (nk * nj * ni + 6 * len(eid)) + 2 * (nk + nj + ni)
                       + DC_EDGE_OPS * len(eid) + DC_ROW_OPS * rows
                       + DC_VOXEL_OPS * len(mesh.verts))


def test_on_card_ms_takes_the_fullest_trace(monkeypatch):
    """A profiler trace can miss a call's device events, never add any: the
    smoke's on-card ms is the most of its traces, and a call whose every
    trace missed them all is None instead of failing the run."""
    import chip_smoke

    traces = {"a": iter([0.0198, 0.1805, 0.1790]), "b": iter([])}

    def fake(fn):
        try:
            return {"device_ms": next(traces[fn])}
        except StopIteration:
            raise RuntimeError("torch.profiler saw no kernel") from None

    monkeypatch.setattr(chip_smoke, "device_launches", fake)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    assert chip_smoke.on_card_ms("a", "b") == (0.1805, None)


def test_dc_pass_bounds_by_kernel_name():
    """chip_smoke.py --dc's bound of each K5 pass: the tree's ops at every
    corner for eval, 6 evaluations and 24 ops an edge for the normals, the
    rest of the plain version's ops for the QEF; bytes for the integer
    passes (the earlier flag pass also wrote the ranks); none for a memset or
    the count read."""
    import chip_smoke

    sizes = {"corners": 1000, "words": 30, "edges": 50, "voxels": 40, "tree_ops": 7}
    total = 7 * 1000 + 6 * 50 * 7 + 24 * 50 + 5000

    def bound(name, **kw):
        return chip_smoke.dc_pass_bounds(name, **sizes, total_ops=total, **kw)

    assert bound("eval_kernel")["ops"] == 7000
    assert bound("normals_kernel")["ops"] == 6 * 50 * 7 + 24 * 50
    assert bound("qef_kernel")["ops"] == 5000
    assert bound("flags_kernel")["bytes"] == 4 * 1000 + 12 * 30
    assert bound("flags_kernel", ranked=True)["bytes"] == 4 * 1000 + 24 * 30
    assert bound("scan_kernel")["bytes"] == 24 * 30 + 4 * 40
    assert bound("live_kernel")["bytes"] == 12 * 30 + 4 * 40
    assert bound("edges_kernel")["bytes"] == 24 * 30 + 25 * 50
    assert bound("scan_kernel")["bound_by"] == "bytes"
    assert bound("Memset") is None and bound("Memcpy DtoH") is None


@pytest.mark.parametrize("nx", [7, 32, 33, 65])
def test_dc_word_grids_have_their_rows(nx):
    """chip_smoke's explicit K5 grids: rows of exactly nx voxels, cubic
    voxels, the bolt's bounds inside the grid."""
    import chip_smoke

    bolt = flagships.build_bolt()
    res, (origin, shape) = chip_smoke.dc_word_grid(bolt, nx)
    bb = bolt.bounds()
    assert shape[2] == nx + 1 and min(shape) >= 3
    far = np.asarray(origin) + (np.asarray(shape[::-1]) - 1) * res
    assert np.all(np.asarray(origin) <= np.asarray(bb.min)) and np.all(far >= np.asarray(bb.max))


def test_dc_on_card_holds_the_launch_count(monkeypatch):
    """A K5 call on the card: at most six kernels and no memset, as the
    profiler sees it (a trace that missed the call is None)."""
    import chip_smoke

    seen = iter([{"kernels": 6, "memsets": 0, "copies": 1, "device_ms": 0.2},
                 {"kernels": 6, "memsets": 1, "copies": 1, "device_ms": 0.2},
                 {"kernels": 7, "memsets": 0, "copies": 1, "device_ms": 0.2}])
    monkeypatch.setattr(chip_smoke, "device_launches", lambda fn: next(seen))
    assert chip_smoke.dc_on_card("a", None) == {"kernels": 6, "memsets": 0, "copies": 1}
    for _ in range(2):
        with pytest.raises(RuntimeError, match="expected at most 6 kernels"):
            chip_smoke.dc_on_card("b", None)

    def missed(fn):
        raise RuntimeError("torch.profiler saw no kernel")

    monkeypatch.setattr(chip_smoke, "device_launches", missed)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    assert chip_smoke.dc_on_card("c", None) is None


def test_tile_prune_bytes_and_ops():
    """K6c writes a byte a tile and the count; its plain version runs the
    tree at every tile centre, |d| and the compare there, and 3 operations
    per index of each axis to make the centres (origin + idx * side +
    half)."""
    assert bounds.kernel_bytes("tile_prune", tiles=60) == 64
    assert bounds.kernel_bytes("tile_prune_param", tiles=60, n_params=7) == 92
    shape = (3, 4, 5)
    _, ops = bounds.count_ops(gk.coarse_keep_plain, Builder().new_sphere(1.0),
                              np.float32([-1.2, -1.2, -1.2]), np.float32(0.1), 8, shape, "cpu")
    assert ops == (SPHERE_OPS + 2) * 60 + 3 * (3 + 4 + 5)


def test_tile_atlas_bytes_and_ops():
    """K6a reads each tile's row and writes the atlas (4 B a corner) and
    its case grid (1 B a cube, seams included); its plain version runs the
    tree at every atlas corner, 2 operations per index of each axis of each
    tile to make the positions, and the classification's 10 per atlas
    cube."""
    T, S = 3, 4
    P = S + 1
    corners, cubes = T * P**3, (T * P - 1) * S * S
    assert bounds.kernel_bytes("tile_atlas", corners=corners, cubes=cubes, tiles=T) == (
        4 * 375 + 224 + 36)
    assert bounds.kernel_bytes("tile_atlas_param", corners=corners, cubes=cubes, tiles=T,
                               n_params=5) == 4 * 375 + 224 + 36 + 20
    assert bounds.kernel_bytes("tile_global_ids", active=10, tiles=T) == 80 + 36
    assert bounds.kernel_bytes("emit_soup", active=1, tris=2, tiles=T) == (
        bounds.kernel_bytes("emit_soup", active=1, tris=2) + 36)
    tiles = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 2]], dtype=torch.int32)
    (dist, cases), ops = bounds.count_ops(
        gk.tile_grid_plain, Builder().new_sphere(1.0), tiles, np.float32([-1.2] * 3),
        np.float32(0.15), S, (7, 8, 9), "cpu")
    assert dist.numel() == corners and cases.numel() == cubes
    assert ops == SPHERE_OPS * corners + 6 * T * P + 10 * cubes


@pytest.mark.parametrize("name", ["scene", "bolt"])
def test_raymarch_ops_count_what_the_plain_version_does(name):
    """K8's ops from its evaluation count (bounds.raymarch_ops) equal the
    operations of its plain version on the same frame, which marches only
    the rays that are not done, as the kernel does."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.visual.raymarch import auto_relax, camera

    b = Builder()
    tree = (flagships.build_bolt() if name == "bolt"
            else b.smooth_union(0.1, b.new_sphere(0.7), b.new_box(1.0, 0.6, 0.4, 0.05)))
    cam = camera(tree, 0.6, 0.5, 2.4)
    (_, evals), ops = bounds.count_ops(rk.raymarch_plain, tree, cam, 24, 20, 40,
                                       auto_relax(tree), 2, "cpu", True)
    assert ops == bounds.raymarch_ops(tree, int(evals.sum()), evals.numel())
    assert int(evals.sum()) < 45 * evals.numel()  # rays stop before the step limit


def test_raymarch_bytes():
    assert bounds.kernel_bytes("raymarch", pixels=512 * 512) == 3 * 512 * 512
    assert bounds.kernel_bytes("raymarch_param", pixels=100, n_params=50) == 500
