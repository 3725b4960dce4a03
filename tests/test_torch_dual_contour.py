"""Dual contouring of the PyTorch port against the JAX package's (CPU).

The analogs of tests/test_dual_contour.py, each through the port's
`DualContourRenderer` on the CPU (K5's plain version, ops/dc_emit.py) and,
where it says so, through `gsdf_tpu`'s on the JAX CPU backend under
`jax.disable_jit()` (so that XLA-CPU's FMA contraction moves nothing). Both
packages build the same trees (or carry one over with
`convert.from_reference_tree`).

Exactness against the JAX package. Triangle counts, the host quad
emission's inputs (edge axes and voxel ids, flips, the live-voxel count)
are equal exactly, and so are the host oracle's edge ids, t and raw
normals. Vertices:
- default mode: bit-identical (measured 0 on every tree here);
- chiseled mode, device QEF (l2 = 1e-5 against O(1) rows): bit-identical
  with XLA's CPU atan2, cos and sin substituted into the port's plain
  solve (`xla_transcendentals`); the operations and their order are the
  JAX package's. With the port's own functions (correctly rounded: XLA's
  CPU atan2 differs from them on 16% of float32 inputs, sin and cos on
  1.2%): within 1e-3 * res on every voxel whose normals are not nearly
  coplanar (measured 2.6e-4 * res at most); a nearly coplanar voxel's
  ill-determined system amplifies an ulp of a Jacobi angle, and the count
  of those past 1e-3 * res is held exactly (3 on the oracle part, up to
  3.3e-3 * res; test_dc_chiseled_tolerance_is_the_transcendentals);
- host oracle (float64 numpy solve): bit-identical in both modes.

The scenes are pinned to one box and resolution (see PIN), so that the
JAX side compiles its op-by-op primitives once for the file.

Also: the g++ build of csrc/gsdf_qef.cuh (K5's per-edge and per-voxel
arithmetic) against the plain version on seeded systems, bit for bit; the
summation order table against the JAX package's argsort; the native quad
emission against numpy (both rank backends, both errors); the chunk route
bit for bit; the parametric edit; the bolt golden (resdiv 256 = 99,844).
"""
import contextlib
import ctypes
import shutil
import subprocess
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_dual_contour import _fuzz_tree
from test_fuzz_paths import _seed_range

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.core.wrappers import with_bounds as jax_with_bounds
from gsdf_tpu.geometry import box3 as jax_box3
from gsdf_tpu.render import dual_contour as jdc
from gsdf_tpu_torch import Builder, flagships, native
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.core import mathx as mx
from gsdf_tpu_torch.core.wrappers import with_bounds
from gsdf_tpu_torch.eval import new_cpu_sdf3
from gsdf_tpu_torch.eval.grid_kernels import grid_positions
from gsdf_tpu_torch.geometry import box3
from gsdf_tpu_torch.ops import dc_emit
from gsdf_tpu_torch.ops.dc_tables import GATHER, OFF5
from gsdf_tpu_torch.render import dual_contour as tdc
from gsdf_tpu_torch.render.dual_contour import (
    DualContourLeastSquares,
    DualContourRenderer,
    minecraft_render,
)

CPU = torch.device("cpu")
JAX_CPU = jax.devices("cpu")[0]


def _part(b):
    """The oracle part of tests/test_dual_contour.py:113-156."""
    return b.difference(
        b.smooth_union(0.1, b.new_sphere(0.8), b.new_box(1.2, 1.2, 0.5, 0.05)),
        b.new_cylinder(0.3, 4.0, 0.0),
    )


def _nonuniform(b):
    return b.difference(
        b.smooth_union(0.1, b.new_sphere(0.6), b.new_cylinder(0.3, 1.4, 0.0)),
        b.new_cylinder(0.15, 3.0, 0.0),
    )


#: the scenes of tests/test_dual_contour.py, each pinned (with_bounds) to
#: one box and rendered at one resolution: one grid shape, so that the JAX
#: side, which compiles every primitive op by op for its shapes under
#: disable_jit, compiles them once for the file
PIN = (-1.1, -1.1, -1.1, 1.1, 1.1, 1.1)
RES = 0.06
SCENES = {
    "sphere": lambda b: b.new_sphere(1.0),
    "box": lambda b: b.new_box(1.0, 0.8, 0.6, 0.0),
    "nonuniform": _nonuniform,
    "part": _part,
}


def scene(name, jax_side=False):
    if jax_side:
        return jax_with_bounds(SCENES[name](JaxBuilder()), jax_box3(*PIN))
    return with_bounds(SCENES[name](Builder()), box3(*PIN))


def _spied(module, fn):
    """fn() with module.finish_dc_mesh recorded: (fn's result, its args)."""
    seen = {}
    orig = module.finish_dc_mesh

    def spy(*args):
        seen["args"] = args
        return orig(*args)

    module.finish_dc_mesh = spy
    try:
        return fn(), seen.get("args")
    finally:
        module.finish_dc_mesh = orig


@contextlib.contextmanager
def xla_transcendentals():
    """The port's plain QEF solve with XLA's CPU atan2, cos and sin."""
    def via_jax(fn):
        def run(*xs):
            with jax.disable_jit():
                return torch.from_numpy(np.array(fn(*(x.numpy() for x in xs))))
        return run

    saved = dc_emit._atan2, mx.cos, mx.sin
    dc_emit._atan2, mx.cos, mx.sin = via_jax(jnp.arctan2), via_jax(jnp.cos), via_jax(jnp.sin)
    try:
        yield
    finally:
        dc_emit._atan2, mx.cos, mx.sin = saved


_cache: dict = {}


def render_both(name, chiseled=False, host=False):
    """(jax tris, jax finish args, port tris, port finish args, port
    renderer, port tris with XLA's transcendentals) of a scene, cached per
    module; the last only for the chiseled device QEF, else None."""
    key = (name, chiseled, host)
    if key not in _cache:
        jdc._dc_cache.clear()  # no size hint: every render at the same buffer sizes
        with jax.disable_jit():
            jt, jargs = _spied(jdc, lambda: jdc.DualContourRenderer(
                scene(name, True), RES, jdc.DualContourLeastSquares(chiseled), device=JAX_CPU,
                host_qef=host).render())

        def port():
            return DualContourRenderer(scene(name), RES, DualContourLeastSquares(chiseled),
                                       device=CPU, host_qef=host)

        dc = port()
        tt, targs = _spied(tdc, dc.render)
        tx = None
        if chiseled and not host:
            with xla_transcendentals():
                tx = port().render()
        _cache[key] = (jt, jargs, tt, targs, dc, tx)
    return _cache[key]


def _same_finish_inputs(jargs, targs):
    """The host quad emission's inputs: edge axes, voxel ids, flips, the
    grid's sizes and the live-voxel count (the vertex table's length)."""
    assert jargs[7] == targs[7] == len(targs[0])  # n_vox
    assert tuple(jargs[4:7]) == tuple(targs[4:7])
    for j, t in zip(jargs[1:4], targs[1:4]):  # eax, lin, flips
        np.testing.assert_array_equal(np.asarray(j), np.asarray(t))


def _check_vertices(both):
    """The JAX package's triangles equal the port's bit for bit; for the
    chiseled device QEF, the port's with XLA's atan2, cos and sin."""
    jt, _, tt, _, _, tx = both
    assert jt.shape == tt.shape
    np.testing.assert_array_equal(jt, tt if tx is None else tx)


def _watertight(tris, tol=1e-5):
    """Each directed edge exactly once, with its reverse."""
    q = np.round(tris / tol).astype(np.int64)
    edges = set()
    for t in q:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            e = (tuple(t[a]), tuple(t[b]))
            if e in edges:
                return False
            edges.add(e)
    return all((b, a) in edges for (a, b) in edges)


def _edges_balanced(tris, tol=1e-5):
    """Every directed edge matched by as many of its reverse (DC's thin
    features make fins; tests/test_dual_contour.py:_edges_balanced)."""
    q = np.round(tris / tol).astype(np.int64)
    edges = Counter()
    for t in q:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            edges[(tuple(t[a]), tuple(t[b]))] += 1
    return all(edges[e] == edges[(e[1], e[0])] for e in edges)


# --- the renders against the JAX package --------------------------------
@pytest.mark.parametrize("chiseled", [False, True])
def test_dc_sphere(chiseled):
    both = render_both("sphere", chiseled)
    jt, jargs, tt, targs, dc, _ = both
    assert len(tt) == len(jt) > 500
    _same_finish_inputs(jargs, targs)
    _check_vertices(both)
    r = np.linalg.norm(tt.reshape(-1, 3), axis=1)
    assert abs(r.min() - 1) < 0.02 and abs(r.max() - 1) < 0.02
    assert _watertight(tt)
    assert dc.evaluations() == int(np.prod(dc.shape())) + 6 * len(targs[1])


def test_dc_box_sharp_features():
    """Box corners recovered near-exactly in the chiseled mode."""
    both = render_both("box", True)
    jt, jargs, tt, targs, _, _ = both
    assert len(tt) == len(jt) > 100
    _same_finish_inputs(jargs, targs)
    _check_vertices(both)
    verts = tt.reshape(-1, 3)
    for sx in (-0.5, 0.5):
        for sy in (-0.4, 0.4):
            for sz in (-0.3, 0.3):
                assert np.linalg.norm(verts - [sx, sy, sz], axis=1).min() < 0.08
    assert _watertight(tt)


def test_dc_nonuniform_part():
    both = render_both("nonuniform")
    jt, jargs, tt, targs, _, _ = both
    assert len(tt) == len(jt) > 1000
    _same_finish_inputs(jargs, targs)
    _check_vertices(both)
    assert np.all(np.isfinite(tt))


def test_dc_device_matches_host_oracle():
    """Device QEF against the float64 oracle within 1e-3 * res, and each of
    the port's two equal to the JAX package's."""
    dev, host = render_both("part"), render_both("part", host=True)
    td, th = dev[2], host[2]
    assert len(th) == len(td) > 1000
    assert np.abs(th - td).max() < 1e-3 * RES
    _check_vertices(dev)
    _check_vertices(host)


def test_dc_device_matches_host_oracle_chiseled():
    """Chiseled: equal counts, the same on-surface quality as the oracle
    (tests/test_dual_contour.py:131-156), both equal to the JAX package's."""
    dev, host = render_both("part", True), render_both("part", True, host=True)
    _, jargs, td, targs, _, _ = dev
    th = host[2]
    res = RES
    assert len(th) == len(td)
    _same_finish_inputs(jargs, targs)
    _check_vertices(dev)
    _check_vertices(host)
    sdf = new_cpu_sdf3(scene("part"))
    dh = np.abs(sdf.evaluate(th.reshape(-1, 3)))
    dd = np.abs(sdf.evaluate(td.reshape(-1, 3)))
    assert np.quantile(dd, 0.99) <= np.quantile(dh, 0.99) * 1.2 + 0.05 * res
    assert dd.max() <= dh.max() + 0.5 * res


#: chiseled voxels farther than 1e-3 * res from the JAX package's vertex
#: with the port's own transcendentals: all nearly planar (measured)
CHISELED_PAST_TOL = {"sphere": 0, "box": 0, "part": 3}


@pytest.mark.parametrize("name", list(CHISELED_PAST_TOL))
def test_dc_chiseled_tolerance_is_the_transcendentals(name):
    """With its own (correctly rounded) atan2, cos and sin the port's
    chiseled device vertices differ from the JAX package's by ulps of the
    Jacobi angles, which a voxel amplifies where its normals are nearly
    coplanar: its second eigenvalue is below 1e-3 of its largest, so the
    vertex's place in that plane rests on the 1e-5 regularisation alone.
    Every other voxel is within 1e-3 * res (measured 2.6e-4 * res at most);
    of the nearly planar ones, the count past 1e-3 * res is held exactly
    (3 on the oracle part, up to 3.3e-3 * res). With XLA's functions, all
    vertices are equal."""
    jt, jargs, tt, targs, dc, tx = render_both(name, True)
    np.testing.assert_array_equal(jt, tx)
    tv = np.asarray(targs[0])
    d = np.abs(np.asarray(jargs[0])[: len(tv)] - tv).max(axis=1)
    c = dc.contourer
    *_, sums, l2 = dc_emit.voxel_sums_plain(dc.s, dc.origin, dc.res, dc.shape(), CPU,
                                            c.norm_step, c.sqrt_lambda)
    s = sums.double().numpy()
    ev = np.linalg.eigvalsh(np.stack([s[:, [0, 1, 2]], s[:, [1, 3, 4]], s[:, [2, 4, 5]]], 1))
    floor = np.maximum(l2, 1e-6 * ev.sum(axis=1))
    planar = ev[:, 2] > 1e3 * (ev[:, 1] + floor)
    assert len(d) == len(planar) and (~planar).sum() > 100
    assert d[~planar].max() <= 1e-3 * RES
    assert int((d > 1e-3 * RES).sum()) == CHISELED_PAST_TOL[name]
    assert d.max() < 1e-2 * RES


def test_dc_host_edge_field_matches_jax():
    """The oracle's edge field (dc_edges): ids with the flip bit, t and the
    raw central differences equal to _dc_edges_fn's."""
    dc = DualContourRenderer(scene("part"), RES, device=CPU)
    shape = dc.shape()
    e = dc_emit.dc_edges(dc.s, dc.origin, dc.res, shape, CPU, 2e-8)
    with jax.disable_jit():
        fn = jdc._dc_edges_fn(scene("part", True), shape, 65536, 2e-8, JAX_CPU)
        packed = np.asarray(fn(dc.origin, float(dc.res)))
    n = int(packed[:1].view(np.int32)[0])
    assert n == len(e.eids) > 1000
    idw = packed[1 : 1 + n].view(np.int32)
    np.testing.assert_array_equal(idw & 0x7FFFFFFF, e.eids.numpy())
    np.testing.assert_array_equal(idw < 0, e.flips.numpy())
    np.testing.assert_array_equal(packed[1 + 65536 : 1 + 65536 + n], e.t.numpy())
    np.testing.assert_array_equal(
        packed[1 + 2 * 65536 : 1 + 2 * 65536 + 3 * n].reshape(-1, 3), e.normals.numpy())


# --- the fuzz battery -----------------------------------------------------
@pytest.mark.parametrize("seed", _seed_range(6))
def test_dc_fuzz_seeded_trees(seed):
    """tests/test_dual_contour.py:256-281 on the port: balanced edges,
    every vertex within a voxel diagonal of the surface, bit-identical
    repeated renders, device count == oracle count, device vertices within
    1e-3 * res of the oracle's."""
    jtree = _fuzz_tree(seed)
    if jtree is None:
        pytest.skip("builder rejected combination")
    t = from_reference_tree(jtree)
    res = float(t.bounds().diagonal()) / 48
    dc = DualContourRenderer(t, res, device=CPU)
    tris = dc.render()
    assert len(tris) > 100
    assert _edges_balanced(tris)
    d = np.abs(new_cpu_sdf3(t).evaluate(tris.reshape(-1, 3)))
    assert d.max() < res * np.sqrt(3)
    np.testing.assert_array_equal(tris, DualContourRenderer(t, res, device=CPU).render())
    th = DualContourRenderer(t, res, device=CPU, host_qef=True).render()
    assert len(th) == len(tris)
    assert np.abs(th - tris).max() < 1e-3 * res


# --- parametric, guards, analytic corners ---------------------------------
def test_dc_parametric_edit():
    """render(parametric=True) after a rebind equals a fresh baked render
    of the edited tree (within 1e-6; on the CPU both are the plain
    version on the live tree), and the edit changes the surface."""
    b = Builder()
    boss = b.new_cylinder(0.45, 1.2, 0.05)
    body = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), boss)
    pinned = with_bounds(body, box3(-1.2, -0.8, -0.9, 1.2, 0.8, 0.9))
    t0 = DualContourRenderer(pinned, 0.06, device=CPU).render(parametric=True)
    pinned.rebind({boss: {"r": 0.3}})
    t1 = DualContourRenderer(pinned, 0.06, device=CPU).render(parametric=True)
    assert len(t1) != len(t0)
    t_ref = DualContourRenderer(pinned, 0.06, device=CPU).render()
    assert len(t1) == len(t_ref)
    np.testing.assert_allclose(t1, t_ref, atol=1e-6)


def test_dc_edge_id_guard():
    """Edge ids are int32: grids with 3 * nvox >= 2^31 are rejected."""
    s = Builder().new_sphere(1.0)
    with pytest.raises(ValueError, match="edge ids"):
        dc_emit.dc_mesh(s, np.zeros(3, np.float32), 0.01, (900, 900, 900), CPU, 0.01, 0.01)
    with pytest.raises(ValueError, match="edge ids"):
        dc_emit.dc_edges(s, np.zeros(3, np.float32), 0.01, (900, 900, 900), CPU, 0.01)


def test_dc_renderer_rejects_bad_resolutions():
    s = Builder().new_sphere(1.0)
    with pytest.raises(ValueError, match="invalid dual contour resolution"):
        DualContourRenderer(s, 0.0, device=CPU)
    inverted = with_bounds(s, box3(1, 1, 1, -1, -1, -1))
    with pytest.raises(ValueError, match="not fine enough"):
        DualContourRenderer(inverted, 0.1, device=CPU)


def test_dc_qef_analytic_corners():
    """tests/test_dual_contour.py:332-391: a box corner recovered exactly in
    the chiseled mode, chiseled beats default at corners, a rotated box's
    corners within the CPU gate."""
    import math

    b = Builder()
    s = b.new_box(1.0, 0.8, 0.6, 0.0)
    corners = np.array([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.4, 0.4)
                        for sz in (-0.3, 0.3)])

    def worst_miss(tree, cs, chiseled, res=0.1):
        verts = DualContourRenderer(tree, res, DualContourLeastSquares(chiseled),
                                    device=CPU).render().reshape(-1, 3)
        return max(np.linalg.norm(verts - c, axis=1).min() for c in cs)

    assert worst_miss(s, corners, True) < 1e-4
    assert worst_miss(s, corners, False) > 0.01
    ang, axis = 0.35, np.array([1.0, 0.5, 0.25])
    rot = b.rotate(s, ang, tuple(axis))
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * (K @ K)
    assert worst_miss(rot, corners @ R.T, True) < 0.06


# --- the host quad emission ----------------------------------------------
def test_dc_native_finish_matches_numpy():
    """native.dc_finish (both rank backends) == finish_dc_mesh_numpy == the
    JAX package's numpy finish, bit for bit, on a part whose edges touch
    the grid boundary."""
    _, _, tt, args, _, _ = render_both("part")
    offs = tdc._offs()
    tn, bn = tdc.finish_dc_mesh_numpy(*args)
    np.testing.assert_array_equal(tn, tt)
    jn, jb = jdc.finish_dc_mesh_numpy(*args)
    np.testing.assert_array_equal(jn, tn)
    assert jb == bn
    for force_sort in (False, True):
        tc, bc = native.dc_finish(*args, offs, force_sort=force_sort)
        assert bc == bn
        np.testing.assert_array_equal(tc, tn)


def test_dc_native_finish_raises():
    """A voxel-count mismatch and an edge outside the grid raise, never
    truncate (tests/test_dual_contour.py:425-454)."""
    offs = tdc._offs()
    verts = np.zeros((8, 3), np.float32)
    eax = np.array([2], np.int64)
    lin = np.array([(1 * 3 + 1) * 3 + 1], np.int64)
    flips = np.array([False])
    with pytest.raises(RuntimeError, match="voxel-count mismatch"):
        native.dc_finish(verts, eax, lin, flips, 3, 3, 3, 99, offs)
    with pytest.raises(RuntimeError, match="voxel-count mismatch"):
        tdc.finish_dc_mesh_numpy(verts, eax, lin, flips, 3, 3, 3, 99)
    for bad_eax, bad_lin in (([7], [13]), ([2], [27]), ([2], [-1])):
        with pytest.raises(RuntimeError, match="out of range"):
            native.dc_finish(verts, np.array(bad_eax, np.int64), np.array(bad_lin, np.int64),
                             flips, 3, 3, 3, 8, offs)


def test_dc_finish_raises_without_native(monkeypatch):
    """No numpy fallback on the path: a native library that cannot be
    built raises out of finish_dc_mesh."""
    def broken():
        raise RuntimeError("building gsdfnative failed")

    args = render_both("part")[3]
    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="gsdfnative"):
        tdc.finish_dc_mesh(*args)


# --- the chunk route --------------------------------------------------------
class _Laps:
    """stages.Clock without the card: the stage names, in order."""

    def __init__(self):
        self.ms = []

    def lap(self, name):
        self.ms.append(name)


@pytest.mark.parametrize("chunked", [False, True])
def test_stage_breakdown_renders_what_render_renders(chunked, monkeypatch):
    """stages.dc, the by-hand stage split that PERF.md's DC rows come from,
    makes the renderer's triangles (here on the CPU), per chunk past
    mono_voxels."""
    from gsdf_tpu_torch import stages

    s = _part(Builder())
    dcr = DualContourRenderer(s, 0.05, device=CPU)
    if chunked:
        monkeypatch.setattr(DualContourRenderer, "mono_voxels", 1000)
        monkeypatch.setattr(DualContourRenderer, "chunk_points", (dcr.nx + 2) * (dcr.ny + 2) * 8)
    laps = _Laps()
    ntris, nbytes = stages.dc(dcr, laps)
    tris = dcr.render()
    assert ntris == len(tris) > 1000 and nbytes > 0
    n = len(dcr.chunks()[0])
    assert (n > 1) == chunked
    assert laps.ms == ["K5", "fetch"] * n + ["host finish", "STL encode"]



def test_dc_auto_chunk_route_bitexact(monkeypatch):
    """Past mono_voxels the render runs per z-chunk and equals the
    whole-grid render bit for bit; evaluations count the halo planes."""
    s = _part(Builder())
    res = 0.05
    t_mono = DualContourRenderer(s, res, device=CPU).render()
    auto = DualContourRenderer(s, res, device=CPU)
    monkeypatch.setattr(DualContourRenderer, "mono_voxels", 1000)
    monkeypatch.setattr(DualContourRenderer, "chunk_points", (auto.nx + 2) * (auto.ny + 2) * 8)
    t_auto = auto.render()
    np.testing.assert_array_equal(t_auto, t_mono)
    plane_corners = (auto.nx + 1) * (auto.ny + 1)
    c = DualContourRenderer.chunk_points // plane_corners - 2
    n_chunks = -(-auto.nz // c)
    assert n_chunks > 2
    assert auto.evaluations() > n_chunks * (c + 2) * plane_corners
    with pytest.raises(ValueError, match="too tall"):
        tdc.chunk_plan(s, np.float32(1e-8), 10**12)


def test_dc_slab_rows_equal_whole_grid():
    """K5's plain version on a slab (k0, n_own < its layers): the owned
    voxels' vertices and the slab's edges equal the whole grid's."""
    dc = DualContourRenderer(_part(Builder()), 0.05, device=CPU)
    nk, nj, ni = dc.shape()
    whole = dc_emit.dc_mesh(dc.s, dc.origin, dc.res, (nk, nj, ni), CPU, 2e-8, 1e-3)
    k0, c = 17, 5
    slab = dc_emit.dc_mesh(dc.s, dc.origin, dc.res, (c + 2, nj, ni), CPU, 2e-8, 1e-3, k0=k0,
                           n_own=c)
    plane = (nj - 1) * (ni - 1)
    nvox, nvox_s = (nk - 1) * plane, (c + 1) * plane
    we = whole.eids.long()
    wl = we % nvox
    sel = (wl >= k0 * plane) & (wl < (k0 + c + 1) * plane)
    np.testing.assert_array_equal(
        ((we // nvox) * nvox_s + wl - k0 * plane)[sel].numpy(), slab.eids.long().numpy())
    # the live voxels of layers [k0, k0 + c) in the whole grid's order
    offs = []
    for a in range(3):
        for di, dj, dk in OFF5[a]:
            ax = we // nvox == a
            lin = wl[ax]
            i, j, k = lin % (ni - 1), (lin // (ni - 1)) % (nj - 1), lin // plane
            i, j, k = i + di, j + dj, k + dk
            ok = (i >= 0) & (i < ni - 1) & (j >= 0) & (j < nj - 1) & (k >= 0) & (k < nk - 1)
            offs.append(((k * (nj - 1) + j) * (ni - 1) + i)[ok])
    uvox = torch.unique(torch.cat(offs))
    owned = (uvox >= k0 * plane) & (uvox < (k0 + c) * plane)
    lo = int((uvox < k0 * plane).sum())
    assert len(slab.verts) == int(owned.sum()) > 100
    np.testing.assert_array_equal(whole.verts[lo : lo + len(slab.verts)].numpy(),
                                  slab.verts.numpy())


# --- the static summation order, K5's arithmetic by g++ -------------------
def test_gather_order_is_the_jax_argsort_order():
    """GATHER reproduces the JAX package's stable argsort of the
    contributions by voxel (dual_contour.py:296-364) on a dense patch of
    active edges: each voxel's rows come in GATHER's order."""
    nx = ny = nz = 5
    nvox = nx * ny * nz
    eid = np.arange(3 * nvox)  # every edge active
    eax, rem = eid // nvox, eid % nvox
    ek, ej, ei = rem // (ny * nx), (rem // nx) % ny, rem % nx
    sent = nvox
    con = []
    for c in range(5):
        off = np.array([OFF5[a][c] for a in range(3)])[eax]
        ii, jj, kk = ei + off[:, 0], ej + off[:, 1], ek + off[:, 2]
        ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny) & (kk >= 0) & (kk < nz)
        con.append(np.where(ok, (kk * ny + jj) * nx + ii, sent))
    con = np.stack(con, axis=1).reshape(-1)
    order = np.argsort(con, kind="stable")
    v = (2 * ny + 2) * nx + 2  # an interior voxel: all 15 rows
    rows = order[con[order] == v] // 5  # source edge slots, in summation order
    want = [a * nvox + ((2 + dk) * ny + 2 + dj) * nx + 2 + di
            for a in range(3) for di, dj, dk in GATHER[a]]
    np.testing.assert_array_equal(eid[rows], want)


@pytest.fixture(scope="module")
def qef_lib(tmp_path_factory):
    """csrc/gsdf_qef.cuh built by g++ (-O1 -ffp-contract=off) with a shim."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    d = tmp_path_factory.mktemp("qef")
    (d / "shim.cpp").write_text(
        "#include <math.h>\n"
        "#define GSDF_QEF_ATAN2(y, x) ((float)atan2((double)(y), (double)(x)))\n"
        "#define GSDF_QEF_COS(x) ((float)cos((double)(x)))\n"
        "#define GSDF_QEF_SIN(x) ((float)sin((double)(x)))\n"
        '#include "gsdf_qef.cuh"\n'
        'extern "C" void solve(const float* s, float l2, float* x, long n) {\n'
        "    for (long v = 0; v < n; ++v) gsdf_dc::qef_solve(s + 13 * v, l2, x + 3 * v);\n}\n"
        'extern "C" void sums(const float* nrm, const float* q, const int* valid, float* s,'
        " long n) {\n"
        "    for (long v = 0; v < n; ++v) {\n"
        "        float* o = s + 13 * v;\n"
        "        for (int c = 0; c < 13; ++c) o[c] = 0.0f;\n"
        "        for (int r = 0; r < 15; ++r)\n"
        "            if (valid[15 * v + r]) gsdf_dc::qef_add(o, nrm + 3 * (15 * v + r),"
        " q + 3 * (15 * v + r));\n    }\n}\n"
        'extern "C" void edges(const float* d0, const float* de, float* t, int* bits, long n) {\n'
        "    for (long k = 0; k < n; ++k) {\n"
        "        t[k] = gsdf_dc::edge_t(d0[k], de[k]);\n"
        "        bits[k] = gsdf_dc::edge_active(d0[k], de[k]) | gsdf_dc::edge_flip(d0[k], de[k])"
        " << 1;\n    }\n}\n"
        'extern "C" void corners(float ox, float oy, float oz, float res, int k0, int nk,'
        " int nj, int ni, float* p) {\n"
        "    for (int k = 0; k < nk; ++k) for (int j = 0; j < nj; ++j) for (int i = 0; i < ni;"
        " ++i)\n"
        "        gsdf_dc::corner_position(ox, oy, oz, res, i, j, k0 + k,"
        " p + 3 * ((k * nj + j) * ni + i));\n}\n"
    )
    so = d / "libqef.so"
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I",
         dc_emit.__file__.rsplit("/ops/", 1)[0] + "/csrc", "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    for fn in ("solve", "sums", "edges", "corners"):
        getattr(lib, fn).restype = None
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _systems(seed, n=4000):
    """Seeded voxels: up to 15 rows of normals (some zero, some tiny, some
    O(1), as the two modes make them) and crossings in [-0.1, 1.1]."""
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.0, 1e-8, 1.0, 5e3], size=(n, 15, 1))
    nrm = (rng.normal(size=(n, 15, 3)) * scale).astype(np.float32)
    q = rng.uniform(-0.1, 1.1, (n, 15, 3)).astype(np.float32)
    valid = (rng.random((n, 15)) < 0.5).astype(np.int32)
    valid[:, 0] = 1
    return nrm, q, valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chiseled", [False, True])
def test_qef_header_matches_plain(qef_lib, seed, chiseled):
    """gsdf_qef.cuh's sums and solve (K5's per-voxel arithmetic, by g++,
    with the plain version's atan2, cos and sin on the CPU: float64,
    rounded once) against qef_rows, the ordered sum and qef_solve_plain,
    bit for bit, on well- and ill-conditioned systems of both modes."""
    c = DualContourLeastSquares(chiseled)
    _, _, l2 = dc_emit.qef_constants(c.norm_step, c.sqrt_lambda)
    nrm, q, valid = _systems(seed)
    n = len(nrm)
    s_c = np.empty((n, 13), np.float32)
    qef_lib.sums(_ptr(nrm), _ptr(q), _ptr(valid), _ptr(s_c), ctypes.c_long(n))
    rows = dc_emit.qef_rows(torch.from_numpy(nrm), torch.from_numpy(q))
    rows = torch.where(torch.from_numpy(valid.astype(bool))[..., None], rows, 0.0)
    s_t = torch.zeros((n, 13))
    for r in range(15):
        s_t = s_t + rows[:, r]
    np.testing.assert_array_equal(s_c, s_t.numpy())
    x_c = np.empty((n, 3), np.float32)
    qef_lib.solve(_ptr(s_c), ctypes.c_float(l2), _ptr(x_c), ctypes.c_long(n))
    x_t = dc_emit.qef_solve_plain(s_t, l2).numpy()
    np.testing.assert_array_equal(x_c, x_t)
    assert np.all(s_c[:, :9] == 0, axis=1).any() and (np.abs(x_c) < 1.1).any()


def test_edge_header_matches_plain(qef_lib):
    """gsdf_qef.cuh's edge test, t and flip against edge_flags_plain and
    edge_values_plain, with signed zeros (DC counts -0.0 as negative) and
    equal ends."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.normal(size=4000), [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    n = 20000
    d0 = rng.choice(vals, n).astype(np.float32)
    de = np.where(rng.random(n) < 0.1, d0, rng.choice(vals, n)).astype(np.float32)
    t = np.empty_like(d0)
    bits = np.empty(n, np.int32)
    qef_lib.edges(_ptr(d0), _ptr(de), _ptr(t), _ptr(bits), ctypes.c_long(n))
    # one row of corners d0, de, d0, de, ...: the even voxels' x edges
    grid = torch.zeros((2, 2, 2 * n))
    grid[0, 0, 0::2] = torch.from_numpy(d0)
    grid[0, 0, 1::2] = torch.from_numpy(de)
    flags = dc_emit.edge_flags_plain(grid)[0, 0, 0, 0::2].numpy()
    tt, flip = (x.numpy() for x in dc_emit.edge_values_plain(torch.from_numpy(d0),
                                                             torch.from_numpy(de)))
    np.testing.assert_array_equal(bits & 1, flags.astype(np.int32))
    np.testing.assert_array_equal(bits >> 1, flip.astype(np.int32))
    np.testing.assert_array_equal(t, tt)
    assert (np.signbit(d0) & (d0 == 0)).any() and (d0 == de).any()


def test_grid_pass_positions_are_k2s(qef_lib):
    """K5's grid pass makes each corner's position as K2 does: the header's
    corner_position equals grid_positions (K2's plain version, which K2
    equals bit for bit on the card) at a slab offset."""
    origin = np.array([-1.3, 0.7, -25.1], np.float32)
    res = np.float32(0.0371)
    shape, k0 = (5, 7, 9), 83
    p = np.empty(shape + (3,), np.float32)
    qef_lib.corners(ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
                    ctypes.c_float(origin[2]), ctypes.c_float(res), k0, *shape, _ptr(p))
    np.testing.assert_array_equal(p, grid_positions(origin, res, shape, CPU, k0).numpy())


# --- minecraft, the bolt golden ------------------------------------------
def test_minecraft_render_matches_jax():
    with jax.disable_jit():
        jm = jdc.minecraft_render(scene("sphere", True), RES, device=JAX_CPU)
    tm = minecraft_render(scene("sphere"), RES, device=CPU)
    assert len(tm) > 1000
    np.testing.assert_array_equal(jm, tm)


def test_dc_bolt_golden_count():
    """The bolt scene at resdiv 256: exactly 99,844 triangles through the
    device QEF's plain version and through the host oracle, bit-stable."""
    bolt = flagships.build_bolt()
    res = bolt.bounds().diagonal() / 256
    t1 = DualContourRenderer(bolt, res, device=CPU).render()
    assert len(t1) == 99844
    np.testing.assert_array_equal(t1, DualContourRenderer(bolt, res, device=CPU).render())
    th = DualContourRenderer(bolt, res, device=CPU, host_qef=True).render()
    assert len(th) == 99844


def test_dc_renderer_defaults_to_the_card(monkeypatch):
    """With no device named the renderer runs on the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DualContourRenderer(Builder().new_sphere(1.0), 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minecraft_render(Builder().new_sphere(1.0), 0.1)
