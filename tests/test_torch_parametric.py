"""Parametric evaluation of the PyTorch port against the JAX package (CPU).

Three layers:

- the bookkeeping: `CONT_PARAMS` of every node class, `param_spec`,
  `pack_params` and `structural_hash`, equal to the JAX package's exactly
  (names, shapes, bytes) on the golden parts, the every-type tree, one
  recipe per node type and trees carried over with `from_reference_tree`;
- `Shader.rebind` and `ParametricSDF3/2`: the analogs of the JAX
  package's tests/test_parametric.py and tests/test_rebind.py. On the CPU
  the port's wrappers run their plain version on the live tree, so these
  hold the API, its errors and the values: within 1e-6 (atol, the JAX
  package's own budget: its jitted operand-bound executable contracts
  multiply-adds) of `gsdf_tpu`'s ParametricSDF and of a fresh tree;
- the parametric emitters, built by g++ (`-O1 -ffp-contract=off`, the very
  text nvcc builds): `gsdf_tree(P, p)` against the plain version (atol
  1e-5, signs equal: the C library's transcendentals and torch's differ by
  an ulp), against the baked build (bit for bit: the same IEEE operations
  in the same order), and with a second, structurally equal tree's vector
  against that tree's plain version. A wrong slice offset shows here.
"""
import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch
from test_fuzz_paths import _random_tree
from test_torch_nodes import (
    JAX_KIT,
    NODE_CASES,
    PARTS,
    TORCH_KIT,
    _codegen_trees,
    _jax_node_classes,
    _parts,
    both,
    points,
    torch_distance,
)

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.core.wrappers import with_bounds as jax_with_bounds
from gsdf_tpu.eval import new_cpu_sdf3 as jax_new_cpu_sdf3
from gsdf_tpu.eval import new_sdf2 as jax_new_sdf2
from gsdf_tpu.eval import parametric as jpar
from gsdf_tpu.forge import threads as jax_threads
from gsdf_tpu.geometry.boxes import Box as JaxBox
from gsdf_tpu_torch import Builder, _build, kernels
from gsdf_tpu_torch.codegen.cuda import Codegen, tree_source
from gsdf_tpu_torch.convert import NODE_TYPES, from_reference_tree
from gsdf_tpu_torch.core.ops2 import Rotation2D
from gsdf_tpu_torch.core.ops3 import Transform
from gsdf_tpu_torch.core.wrappers import with_bounds
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.eval import new_cpu_sdf3, new_sdf2
from gsdf_tpu_torch.eval.parametric import (
    ParametricSDF2,
    ParametricSDF3,
    kernel_index,
    kernel_params,
    pack_params,
    param_spec,
    structural_hash,
)
from gsdf_tpu_torch.forge import threads
from gsdf_tpu_torch.geometry.boxes import Box
from gsdf_tpu_torch.render.flat import FlatRenderer

CPU = jax.devices("cpu")[0]
bld = Builder()
jbld = JaxBuilder()


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _spec_names(spec):
    return [(type(n).__qualname__, name, shape) for n, name, shape in spec]


def _same_bookkeeping(jtree, ttree):
    """pack_params, param_spec's (class, attribute, shape) list and
    structural_hash of the port's tree equal the JAX package's."""
    assert _spec_names(param_spec(ttree)) == _spec_names(jpar.param_spec(jtree))
    got, want = pack_params(ttree), jpar.pack_params(jtree)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert structural_hash(ttree) == jpar.structural_hash(jtree)


def _every_type(b, kit_threads, wb, box):
    import chip_smoke

    return chip_smoke.every_type_tree(b, kit_threads, wb, box)


# --- the bookkeeping ------------------------------------------------------
@pytest.mark.parametrize("jcls", _jax_node_classes(), ids=lambda c: c.__qualname__)
def test_cont_params_match_jax(jcls):
    cls = NODE_TYPES[jcls.__qualname__]
    assert tuple(cls.CONT_PARAMS) == tuple(getattr(jcls, "CONT_PARAMS", ()))
    # whatever is continuous is a PARAM, but for the derived inverses
    extra = set(cls.CONT_PARAMS) - set(cls.PARAMS)
    assert extra == ({"t_inv"} if cls in (Transform, Rotation2D) else set())


@pytest.mark.parametrize("name", PARTS + ["every-type"])
def test_bookkeeping_matches_jax_on_parts(name):
    if name == "every-type":
        jtree = _every_type(jbld, jax_threads, jax_with_bounds, JaxBox)
        ttree = _every_type(bld, threads, with_bounds, Box)
    else:
        jtree, ttree = _parts(name)
    _same_bookkeeping(jtree, ttree)
    _same_bookkeeping(jtree, from_reference_tree(jtree))


@pytest.mark.parametrize("case", list(NODE_CASES))
def test_bookkeeping_matches_jax_on_recipes(case):
    jtree, ttree = both(NODE_CASES[case])
    _same_bookkeeping(jtree, ttree)
    _same_bookkeeping(jtree, from_reference_tree(jtree))


def _shared(b):
    """One sphere object under three parents, one box object under two."""
    s = b.new_sphere(0.3)
    box = b.new_box(0.4, 0.3, 0.2, 0.02)
    return b.union(
        b.translate(s, 1.0, 0, 0),
        b.translate(s, -1.0, 0, 0),
        b.smooth_union(0.1, b.scale(s, 1.5), box),
        b.translate(box, 0, 1.0, 0),
    )


def test_shared_nodes_pack_once_and_convert_once():
    jtree, ttree = _shared(jbld), _shared(bld)
    _same_bookkeeping(jtree, ttree)
    conv = from_reference_tree(jtree)
    _same_bookkeeping(jtree, conv)
    assert conv.joined[0].s is conv.joined[1].s is conv.joined[2].s1.s
    # 3+3+1 (k)+1 (factor)+3, sphere r once, box dims+round once
    assert pack_params(ttree).size == 11 + 1 + 4
    # the kernels' layout holds every occurrence: the sphere thrice, the box twice
    assert kernel_params(ttree).size == 11 + 3 * 1 + 2 * 4
    assert pack_params(ttree)[kernel_index(ttree)].tobytes() == kernel_params(ttree).tobytes()


def test_pack_params_roundtrip():
    t = _part(bld, 0.6, (0.8, 0.5, 0.9), 0.1, (0.4, 0.1, -0.2))
    flat = pack_params(t)
    # k + r + dims(3) + round + translate(3) = 9 floats
    assert flat.size == 9
    assert flat.dtype == np.float32
    assert pack_params(bld.new_polygon([[0, 0], [1, 0], [0, 1]])).tobytes() == bytes(4)


def test_structural_hash_masks_values_keeps_shapes():
    a = _part(bld, 0.6, (0.8, 0.5, 0.9), 0.1, (0.4, 0.1, -0.2))
    b = _part(bld, 0.7, (0.6, 0.7, 0.4), 0.2, (-0.1, 0.3, 0.1))
    assert structural_hash(a) == structural_hash(b) and a.tree_hash() != b.tree_hash()
    # a structural parameter (the cylinder's rounding mode) changes it
    assert structural_hash(bld.new_cylinder(1, 2, 0.0)) != structural_hash(
        bld.new_cylinder(1, 2, 0.1)
    )
    assert structural_hash(bld.new_cylinder(1, 2, 0.1)) == structural_hash(
        bld.new_cylinder(1.5, 3, 0.1)
    )


# --- ParametricSDF3/2, after tests/test_parametric.py ---------------------
def _part(b, r, box, k, shift):
    return b.smooth_union(k, b.new_sphere(r), b.translate(b.new_box(*box, 0.05), *shift))


def _both_parts(*args):
    return _part(jbld, *args), _part(bld, *args)


def test_parametric_matches_fresh_tree():
    j1, t1 = _both_parts(0.6, (0.8, 0.5, 0.9), 0.1, (0.4, 0.1, -0.2))
    psdf = ParametricSDF3(t1, "cpu")
    jpsdf = jpar.ParametricSDF3(j1, CPU)
    assert psdf.n_params() == jpsdf.n_params() == 9
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (1024, 3)).astype(np.float32)
    _close(psdf.evaluate(pts), new_cpu_sdf3(t1).evaluate(pts))
    _close(psdf.evaluate(pts), jpsdf.evaluate(pts))
    # edit every continuous parameter; same structure, new values
    j2, t2 = _both_parts(0.75, (0.6, 0.7, 0.4), 0.2, (-0.1, 0.3, 0.1))
    assert structural_hash(t2) == structural_hash(t1)
    assert t2.tree_hash() != t1.tree_hash()
    _close(psdf.evaluate(pts, t2), new_cpu_sdf3(t2).evaluate(pts))
    _close(psdf.evaluate(pts, t2), jpsdf.evaluate(pts, j2))


def test_parametric_structure_mismatch_raises():
    t1 = _part(bld, 0.6, (0.8, 0.5, 0.9), 0.1, (0.4, 0.1, -0.2))
    psdf = ParametricSDF3(t1, "cpu")
    other = bld.union(bld.new_sphere(1.0), bld.new_sphere(2.0))
    with pytest.raises(ValueError, match="structure differs"):
        psdf.evaluate(np.zeros((4, 3), np.float32), other)


def test_parametric_sharing_mismatch_raises():
    """Same structure, but the edited tree shares a node the compiled one
    holds twice: the packed vectors differ in length."""
    s = bld.new_sphere(0.5)
    two = bld.union(bld.translate(bld.new_sphere(0.5), 1, 0, 0), bld.new_sphere(0.5))
    one = bld.union(bld.translate(s, 1, 0, 0), s)
    assert structural_hash(one) == structural_hash(two)
    with pytest.raises(ValueError, match="parameter count mismatch"):
        ParametricSDF3(two, "cpu").evaluate(np.zeros((4, 3), np.float32), one)


def test_parametric_type_checks_and_default_device():
    with pytest.raises(TypeError):
        ParametricSDF3(bld.new_circle(1.0), "cpu")
    with pytest.raises(TypeError):
        ParametricSDF2(bld.new_sphere(1.0), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParametricSDF3(bld.new_sphere(1.0))  # the card unless asked otherwise


def test_parametric_screw():
    def screws(length):
        return (
            jax_threads.screw(jbld, length, jax_threads.ISO(d=3, p=0.5, ext=True)),
            threads.screw(bld, length, threads.ISO(d=3, p=0.5, ext=True)),
        )

    j1, s1 = screws(2.0)
    psdf = ParametricSDF3(s1, "cpu")
    jpsdf = jpar.ParametricSDF3(j1, CPU)
    pts = np.random.default_rng(1).uniform(-2, 2, (512, 3)).astype(np.float32)
    _close(psdf.evaluate(pts), new_cpu_sdf3(s1).evaluate(pts))
    # longer screw, same profile polygon: same structure
    j2, s2 = screws(3.0)
    assert structural_hash(s2) == structural_hash(s1)
    _close(psdf.evaluate(pts, s2), new_cpu_sdf3(s2).evaluate(pts))
    # the thread flanks amplify an ulp of atan2 (test_torch_nodes' note): 1e-5
    np.testing.assert_allclose(psdf.evaluate(pts, s2), jpsdf.evaluate(pts, j2), atol=1e-5, rtol=0)


def test_parametric_2d():
    def shapes(b, r, w, h, a):
        return b.annulus(b.union2d(b.new_circle(r), b.new_rectangle(w, h)), a)

    t1, j1 = shapes(bld, 0.5, 0.8, 0.3, 0.1), shapes(jbld, 0.5, 0.8, 0.3, 0.1)
    psdf = ParametricSDF2(t1, "cpu")
    jpsdf = jpar.ParametricSDF2(j1, CPU)
    pts = np.random.default_rng(2).uniform(-1, 1, (512, 2)).astype(np.float32)
    _close(psdf.evaluate(pts), new_sdf2(t1, "cpu").evaluate(pts))
    _close(psdf.evaluate(pts), jpsdf.evaluate(pts))
    t2, j2 = shapes(bld, 0.4, 0.5, 0.6, 0.15), shapes(jbld, 0.4, 0.5, 0.6, 0.15)
    _close(psdf.evaluate(pts, t2), new_sdf2(t2, "cpu").evaluate(pts))
    _close(psdf.evaluate(pts, t2), jpsdf.evaluate(pts, j2))
    _close(jpsdf.evaluate(pts, j2), jax_new_sdf2(j2).evaluate(pts))


def _scan_union(b, r, offs):
    hole = b.new_cylinder(0.08, 2.0, 0.0)
    return b.union(b.new_sphere(r), *[b.translate(hole, *o) for o in offs])


def test_parametric_scan_union():
    offs = np.random.default_rng(3).uniform(-1, 1, (6, 3)).astype(np.float32)
    u1, j1 = _scan_union(bld, 0.3, offs), _scan_union(jbld, 0.3, offs)
    psdf = ParametricSDF3(u1, "cpu")
    jpsdf = jpar.ParametricSDF3(j1, CPU)
    pts = np.random.default_rng(4).uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    _close(psdf.evaluate(pts), new_cpu_sdf3(u1).evaluate(pts))
    u2, j2 = _scan_union(bld, 0.35, offs * 0.5), _scan_union(jbld, 0.35, offs * 0.5)
    _close(psdf.evaluate(pts, u2), new_cpu_sdf3(u2).evaluate(pts))
    _close(psdf.evaluate(pts, u2), jpsdf.evaluate(pts, j2))


def _four_spheres(b, radii):
    spheres = [b.new_sphere(r) for r in radii]
    return b.union(*[b.translate(s, 4.0 * i, 0.0, 0.0) for i, s in enumerate(spheres)]), spheres


def test_parametric_scan_group_member_edit():
    """An edit of ONE member of a loop group shows (the JAX package's
    confirmed bug, tests/test_parametric.py:138-171)."""
    tree, spheres = _four_spheres(bld, [1.0] * 4)
    jtree, jspheres = _four_spheres(jbld, [1.0] * 4)
    psdf = ParametricSDF3(tree, "cpu")
    jpsdf = jpar.ParametricSDF3(jtree, CPU)
    pts = np.array([[4.0 * i, 0.0, 1.5] for i in range(4)], np.float32)
    _close(psdf.evaluate(pts), new_cpu_sdf3(tree).evaluate(pts))
    tree.rebind({spheres[1]: {"r": 2.0}})
    jtree.rebind({jspheres[1]: {"r": 2.0}})
    oracle = new_cpu_sdf3(tree).evaluate(pts)
    assert oracle[1] < 0  # inside the edited sphere
    _close(psdf.evaluate(pts), oracle)
    _close(psdf.evaluate(pts), jpsdf.evaluate(pts))
    tree2, _ = _four_spheres(bld, [0.5 + 0.3 * i for i in range(4)])
    assert structural_hash(tree2) == structural_hash(tree)
    _close(psdf.evaluate(pts, tree2), new_cpu_sdf3(tree2).evaluate(pts))


def test_rebind_transform_rederives_inverse():
    box = bld.new_box(1.0, 0.4, 0.2, 0.0)
    node = bld.rotate(box, 0.3, (0, 0, 1))
    pts = np.random.default_rng(5).uniform(-1.2, 1.2, (256, 3)).astype(np.float32)
    assert isinstance(node, Transform)
    fresh = bld.rotate(bld.new_box(1.0, 0.4, 0.2, 0.0), 1.1, (0, 0, 1))
    node.rebind({node: {"t": fresh.t}})
    np.testing.assert_array_equal(node.t_inv, fresh.t_inv)
    _close(new_cpu_sdf3(node).evaluate(pts), new_cpu_sdf3(fresh).evaluate(pts))
    np.testing.assert_allclose(node.bounds().min, fresh.bounds().min, atol=1e-6)
    # the derived inverse is no PARAM: it cannot be set apart from t
    with pytest.raises(AttributeError):
        node.rebind({node: {"t_inv": np.eye(4, dtype=np.float32)}})
    r2 = bld.rotate2d(bld.new_rectangle(1.0, 0.3), 0.4)
    assert isinstance(r2, Rotation2D)
    fresh2 = bld.rotate2d(bld.new_rectangle(1.0, 0.3), 1.2)
    r2.rebind({r2: {"t": fresh2.t}})
    pts2 = np.random.default_rng(6).uniform(-1, 1, (256, 2)).astype(np.float32)
    _close(new_sdf2(r2, "cpu").evaluate(pts2), new_sdf2(fresh2, "cpu").evaluate(pts2))


@pytest.mark.parametrize("seed", range(6))
def test_parametric_binding_fuzz(seed):
    """The JAX package's six binding-fuzz trees (tests/test_parametric.py
    :215-250), carried over: ParametricSDF3 against a fresh evaluator and
    against gsdf_tpu's ParametricSDF3, before and after the same random
    rebinds. 1e-6 against the port's own evaluator; against the JAX
    package rtol 1e-6 and atol 1e-5, the node-parity tolerance of
    test_torch_nodes.py (an ulp of sin, cos or atan2 at these scales)."""
    rng = np.random.default_rng(400 + seed)
    jt = _random_tree(rng)
    if jt is None:
        pytest.skip("the random combination was rejected at construction")
    bb = jt.bounds()
    if not np.isfinite(bb.diagonal()) or bb.diagonal() <= 0:
        pytest.skip("degenerate bounds")
    t = from_reference_tree(jt)
    _same_bookkeeping(jt, t)
    pts = rng.uniform(bb.min - 0.2, bb.max + 0.2, (2048, 3)).astype(np.float32)
    psdf = ParametricSDF3(t, "cpu")
    jpsdf = jpar.ParametricSDF3(jt, CPU)
    _close(psdf.evaluate(pts), new_cpu_sdf3(t).evaluate(pts))
    np.testing.assert_allclose(psdf.evaluate(pts), jpsdf.evaluate(pts), rtol=1e-6, atol=1e-5)
    spec, jspec = param_spec(t), jpar.param_spec(jt)
    if not spec:
        pytest.skip("tree has no continuous parameters")
    h0 = structural_hash(t)
    for i in rng.choice(len(spec), size=min(3, len(spec)), replace=False):
        (node, name, _), (jnode, _, _) = spec[int(i)], jspec[int(i)]
        if name not in node.PARAMS:
            continue  # a derived inverse: rebound through t
        new = np.asarray(getattr(node, name), np.float32) * np.float32(1.05) + np.float32(0.01)
        t.rebind({node: {name: new}})
        jt.rebind({jnode: {name: new}})
    assert structural_hash(t) == h0
    _same_bookkeeping(jt, t)
    _close(psdf.evaluate(pts), new_cpu_sdf3(t).evaluate(pts))
    np.testing.assert_allclose(psdf.evaluate(pts), jpsdf.evaluate(pts), rtol=1e-6, atol=1e-5)


# --- Shader.rebind and the renders, after tests/test_rebind.py ------------
def _boss_part(b):
    hole = b.new_cylinder(0.25, 4.0, 0.0)
    body = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), b.new_cylinder(0.45, 1.2, 0.05))
    return b.difference(body, hole), body.s2  # (tree, boss cylinder)


def _pinned(b, wb, box):
    part, cyl = _boss_part(b)
    return wb(part, box([-1.2, -0.8, -0.9], [1.2, 0.8, 0.9])), cyl


@pytest.mark.parametrize("path", ["render_indexed", "render_compact"])
def test_rebind_zero_new_libraries(path):
    """The edit loop through the normal entry points: a rebind and a
    second parametric render build and load nothing, the mesh changes, and
    it equals the JAX package's render of the same edit (counts and
    connectivity exact, vertices within 1e-5: an ulp of the corner
    distances through the interpolation)."""
    pinned, cyl = _pinned(bld, with_bounds, Box)
    jpinned, jcyl = _pinned(jbld, jax_with_bounds, JaxBox)
    fr = FlatRenderer(pinned, 0.05, "cpu")
    _, i0 = getattr(fr, path)(parametric=True)
    counts, libs = dict(_build.COUNTS), len(kernels._libs)
    pinned.rebind({cyl: {"r": 0.35}})
    jpinned.rebind({jcyl: {"r": 0.35}})
    v1, i1 = getattr(fr, path)(parametric=True)
    assert len(i1) != len(i0)  # the geometry changed
    assert dict(_build.COUNTS) == counts and len(kernels._libs) == libs
    # the baked render of the edited tree, and the JAX package's
    v2, i2 = getattr(FlatRenderer(pinned, 0.05, "cpu"), path)()
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)
    from gsdf_tpu.render.flat import FlatRenderer as JaxFlatRenderer

    jv, ji = getattr(JaxFlatRenderer(jpinned, 0.05, device=CPU), path)(parametric=True)
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_allclose(v1, jv, rtol=0, atol=1e-5)


def test_parametric_render_follows_direct_attribute_edits():
    """tests/test_parametric.py:99-135: the sphere's radius set on the
    node itself; the welded render follows it."""
    sph = bld.new_sphere(0.5)
    part = with_bounds(bld.union(sph, bld.new_box(0.4, 0.4, 1.0, 0.05)),
                       Box([-1, -1, -1], [1, 1, 1]))
    fr = FlatRenderer(part, 0.06, "cpu")
    _, i1 = fr.render_indexed(parametric=True)
    for r in (0.8, 0.7):
        object.__setattr__(sph, "r", np.float32(r))
        v, i = fr.render_indexed(parametric=True)
        assert len(i) != len(i1)
        far = np.linalg.norm(v[i].reshape(-1, 3), axis=1).max()
        assert r - 0.02 < far < r + 0.02


@pytest.mark.parametrize("route", ["slabbed", "max_cubes", "unresolved"])
def test_parametric_reaches_every_route(route, monkeypatch):
    """render_compact(parametric=True) passes the flag down the slabbed
    route, the int32-id route (render_indexed) and the unresolved-owner
    route (the soup, welded): no route calls K1's wrapper without it."""
    from gsdf_tpu_torch.ops import compact_field, fused_render, fused_welded
    from gsdf_tpu_torch.render import flat

    seen = []
    real = gk.classified_grid

    def spy(tree, origin, res, shape, device, k0=0, parametric=False):
        seen.append(parametric)
        return real(tree, origin, res, shape, device, k0, parametric)

    for mod in (compact_field, fused_render, fused_welded):
        monkeypatch.setattr(mod, "classified_grid", spy)
    tree = bld.union(bld.new_sphere(0.5), bld.new_box(0.4, 0.4, 1.0, 0.05))
    if route == "unresolved":  # the surface crosses the far faces of the box
        tree = with_bounds(tree, Box([-0.6, -0.6, -0.6], [0.3, 0.3, 0.3]))
    fr = FlatRenderer(tree, 0.06, "cpu")
    want = FlatRenderer(tree, 0.06, "cpu").render_compact()
    seen.clear()
    if route == "slabbed":
        fr.compact_cubes = 2000
    elif route == "max_cubes":
        monkeypatch.setattr(flat, "MAX_CUBES", 1)
    got = fr.render_compact(parametric=True)
    assert seen and all(seen)
    if route == "slabbed":
        assert len(seen) > 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_render_has_no_parametric_argument():
    import inspect

    assert "parametric" not in inspect.signature(FlatRenderer.render).parameters
    for name in ("render_indexed", "render_compact"):
        p = inspect.signature(getattr(FlatRenderer, name)).parameters["parametric"]
        assert p.default is False


def test_rebind_invalidates_tree_hash():
    s = bld.new_sphere(0.5)
    tree = bld.union(s, bld.new_box(1, 1, 1, 0))
    h0, k0, sh0 = tree.tree_hash(), tree.struct_key(), structural_hash(tree)
    assert tree.rebind({s: {"r": 0.7}}) is tree
    assert tree.tree_hash() != h0  # baked paths get a fresh key
    assert tree.struct_key() == k0 and structural_hash(tree) == sh0
    assert type(s.r) is np.float32
    d = s.distance(torch.zeros((1, 3)))
    np.testing.assert_allclose(d.numpy(), [-0.7], atol=1e-7)


def test_rebind_rejects_structural_and_foreign():
    s = bld.new_sphere(0.5)
    tree = bld.union(s, bld.new_box(1, 1, 1, 0))
    other = bld.new_sphere(1.0)
    with pytest.raises(ValueError, match="not in this tree"):
        tree.rebind({other: {"r": 0.2}})
    with pytest.raises(AttributeError, match="no parameter 'nope'"):
        tree.rebind({s: {"nope": 1.0}})
    poly = bld.new_polygon(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    with pytest.raises(ValueError, match="structural"):
        bld.extrude(poly, 1.0).rebind({poly: {"vert": 0.0}})
    cyl = bld.new_cylinder(1.0, 2.0, 0.1)
    with pytest.raises(ValueError, match="structural"):
        cyl.rebind({cyl: {"round": 0.0}})
    screw = threads.screw(bld, 2.0, threads.ISO(d=3, p=0.5, ext=True))
    with pytest.raises(ValueError, match="structural"):
        screw.rebind({screw: {"taper": 0.1}})


def test_rebind_shape_mismatch():
    s = bld.new_sphere(0.5)
    with pytest.raises(ValueError, match="shape"):
        s.rebind({s: {"r": np.zeros(3, np.float32)}})
    box = bld.new_box(1, 1, 1, 0)
    with pytest.raises(ValueError, match="shape"):
        box.rebind({box: {"dims": 1.0}})


def test_rebind_messages_match_jax():
    msgs = []
    for b in (jbld, bld):
        s = b.new_sphere(0.5)
        tree = b.union(s, b.new_cylinder(1.0, 2.0, 0.1))
        out = []
        for edits in (
            {b.new_sphere(1.0): {"r": 0.2}},
            {s: {"nope": 1.0}},
            {tree.joined[1]: {"round": 0.0}},
            {s: {"r": np.zeros(3, np.float32)}},
        ):
            with pytest.raises((ValueError, AttributeError)) as e:
                tree.rebind(edits)
            out.append((type(e.value).__name__, str(e.value)))
        msgs.append(out)
    assert msgs[0] == msgs[1]


# --- the parametric emitters, built by g++ --------------------------------
def _perturbed(tree):
    """`tree` with every continuous parameter changed in place (x * 1.05 +
    0.01; a derived inverse follows its matrix)."""
    edits: dict = {}
    for node, name, _ in param_spec(tree):
        if name in node.PARAMS:
            old = np.asarray(getattr(node, name), np.float32)
            edits.setdefault(node, {})[name] = old * np.float32(1.05) + np.float32(0.01)
    return tree.rebind(edits) if edits else tree


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """One g++ build of every codegen tree's parametric and baked source:
    {name: (tree, parametric(p, P) -> distances, baked(p) -> distances)}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    d = tmp_path_factory.mktemp("codegen_param")
    trees = _codegen_trees()
    shim = ["#include <math.h>", "#include <stdint.h>", "#include <string.h>"]
    for i, tree in enumerate(trees.values()):
        # a first line of its own: two recipes of one structure have the
        # same parametric text, and g++ takes `#pragma once` by content
        (d / f"param{i}.cuh").write_text(f"// {i}\n" + tree_source(tree, parametric=True))
        (d / f"baked{i}.cuh").write_text(f"// {i}\n" + tree_source(tree))
        point = ", ".join(f"p[{tree.NDIM} * k + {c}]" for c in range(tree.NDIM))
        shim.append(
            f'namespace param{i} {{\n#include "param{i}.cuh"\n'
            f"static_assert(GSDF_NPARAMS == {kernel_params(tree).size}, \"the vector's length\");\n}}\n"
            f'namespace baked{i} {{\n#include "baked{i}.cuh"\n}}\n'
            f'extern "C" void peval{i}(const float* p, const float* P, float* out, long n) {{\n'
            f"    for (long k = 0; k < n; ++k)\n"
            f"        out[k] = param{i}::gsdf_tree(P, {point});\n}}\n"
            f'extern "C" void beval{i}(const float* p, const float* P, float* out, long n) {{\n'
            f"    for (long k = 0; k < n; ++k)\n"
            f"        out[k] = baked{i}::gsdf_tree({point});\n}}"
        )
    (d / "shim.cpp").write_text("\n".join(shim) + "\n")
    so = d / "libshim.so"
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=900,
    )
    lib = ctypes.CDLL(str(so))

    def evaluator(name):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
        fn.restype = None

        def run(p, P=None):
            p = np.ascontiguousarray(p, np.float32)
            P = np.zeros(1, np.float32) if P is None else np.ascontiguousarray(P, np.float32)
            out = np.empty(len(p), np.float32)
            fn(p.ctypes.data, P.ctypes.data, out.ctypes.data, len(p))
            return out

        return run

    return {
        name: (tree, evaluator(f"peval{i}"), evaluator(f"beval{i}"))
        for i, (name, tree) in enumerate(trees.items())
    }


_CODEGEN_NAMES = (
    list(NODE_CASES) + [f"{n}/2d" for n, r in NODE_CASES.items() if r(bld, TORCH_KIT).NDIM == 2]
    + PARTS + ["nine-types", "every-type"]
)


@pytest.mark.parametrize("name", _CODEGEN_NAMES)
def test_parametric_codegen_matches_plain_and_baked(name, host_kernels):
    tree, run_param, run_baked = host_kernels[name]
    p = points(tree, seed=3)
    got = run_param(p, kernel_params(tree))
    ref = torch_distance(tree, p)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got < 0, ref < 0)
    # the same float32 operations in the same order: bit for bit
    assert got.tobytes() == run_baked(p).tobytes()
    # the same library, a structurally equal tree's values
    other = _perturbed(_codegen_trees()[name])
    assert structural_hash(other) == structural_hash(tree)
    assert kernel_params(other).size == kernel_params(tree).size
    got2 = run_param(p, kernel_params(other))
    ref2 = torch_distance(other, p)
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=1e-5, equal_nan=True)
    ok = np.isfinite(ref2)
    np.testing.assert_array_equal(got2[ok] < 0, ref2[ok] < 0)
    if param_spec(tree):
        assert got2.tobytes() != got.tobytes()


def test_parametric_codegen_honours_one_group_member(host_kernels):
    """The showerhead's 130 holes are one loop over rows of the vector: the
    parametric source has one cylinder function for them, and moving one
    hole moves the distances near it and nowhere else."""
    tree, run_param, _ = host_kernels["showerhead"]
    src = tree_source(tree, parametric=True)
    assert "for (int g = 0; g < 130; ++g)" in src and "* g;" in src
    other = _codegen_trees()["showerhead"]
    union = next(n for n in other.visit_bfs() if len(n.children()) > 100)
    member = union.joined[7]
    other.rebind({member: {"p_": member.p_ + np.float32([0.5, 0, 0])}})
    p = points(tree, seed=5)
    got = run_param(p, kernel_params(other))
    np.testing.assert_allclose(got, torch_distance(other, p), rtol=0, atol=1e-5)
    moved = got != run_param(p, kernel_params(tree))
    assert 0 < moved.sum() < len(p) // 10


def test_parametric_source_shares_functions_by_structure():
    """Two subtrees of one structure and different values are one function
    read through two slices; baked, they are two functions."""
    tree = bld.union(
        bld.translate(bld.new_sphere(0.5), 1, 0, 0), bld.translate(bld.new_sphere(0.7), -1, 0, 0)
    )
    assert tree_source(tree).count("GSDF_HD float sphere_") == 2
    src = tree_source(tree, parametric=True)
    assert src.count("GSDF_HD float sphere_") == 1
    assert src.count("GSDF_HD float translate_") == 1
    assert "#define GSDF_NPARAMS 8" in src and "#define GSDF_PARAMS_BY_VALUE 1" in src
    assert "(P, px, py, pz)" in src and "(P + 4, px, py, pz)" in src
    assert "#define GSDF_PARAMS_BY_VALUE 0" in tree_source(tree, parametric=True, by_value=False)
    # a tree with no continuous parameter still has a one-float vector
    assert "#define GSDF_NPARAMS 1\n" in tree_source(
        bld.new_polygon([[0, 0], [1, 0], [0, 1]]), parametric=True
    )


def test_emitters_read_only_their_own_parameters():
    cg = Codegen(parametric=True)
    tree = bld.translate(bld.new_sphere(0.5), 1, 0, 0)
    cg._stack.append(tree)
    assert cg.p(tree, "p_") == ["P[0]", "P[1]", "P[2]"]
    with pytest.raises(ValueError, match="own node"):
        cg.p(tree.s, "r")
    with pytest.raises(ValueError, match="no child"):
        cg.child_offset(bld.new_sphere(1.0))
    # baked mode: literals, whatever the node
    assert Codegen().p(tree.s, "r") == "0.5f"
