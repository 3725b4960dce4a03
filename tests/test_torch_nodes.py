"""Parity of the PyTorch port's node tree with the JAX package (CPU).

The same numpy inputs (np.random.default_rng) go through the JAX node's
`distance` and the port's. JAX runs op by op (`jax.disable_jit`): jitted
XLA-CPU code contracts multiply-adds into FMAs, which moves about half of
all values by an ulp, while each op alone rounds as IEEE float32, as the
port does. What still differs is the last ulp of the transcendentals
(XLA's atan2, sin, cos and acos against torch's, the port's own cube root
against XLA's) and of torch's CPU sqrt, which is not correctly rounded;
at the flange's 25 mm scale that is below 1e-5: hence rtol=1e-6,
atol=1e-5 for every node, the trigonometric ones (CircularArray, Twist,
Ellipse2D, QuadraticBezier2D, Arc2D, Rotation2D) included.

Also here: the port's tree_hash equals the JAX package's for the golden
parts, `from_reference_tree` carries a part over, the port imports no JAX,
and the CUDA codegen's emitted C, built by g++, matches the plain torch
version.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.core.node import Shader3D as JaxShader3D
from gsdf_tpu.core.wrappers import with_bounds as jax_with_bounds
from gsdf_tpu.forge import threads as jax_threads
from gsdf_tpu.geometry.boxes import Box as JaxBox
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch import flagships as torch_flagships
from gsdf_tpu_torch.codegen.cuda import lit, tree_source
from gsdf_tpu_torch.convert import NODE_TYPES, from_reference_tree
from gsdf_tpu_torch.core import mathx as mx
from gsdf_tpu_torch.core.wrappers import with_bounds as torch_with_bounds
from gsdf_tpu_torch.forge import threads as torch_threads
from gsdf_tpu_torch.geometry.boxes import Box as TorchBox

RTOL, ATOL = 1e-6, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_distance(node, p):
    with jax.disable_jit():
        return np.asarray(node.distance(jnp.asarray(p)))


def torch_distance(node, p):
    return node.distance(torch.from_numpy(p)).numpy()


def points(node, n=4096, seed=0):
    """Random float32 points in the node's bounds grown by 20%."""
    bb = node.bounds()
    lo, hi = bb.min.astype(np.float64), bb.max.astype(np.float64)
    pad = 0.2 * (hi - lo)
    rng = np.random.default_rng(seed)
    return (lo - pad + (hi - lo + 2 * pad) * rng.random((n, len(lo)))).astype(np.float32)


# --- one builder recipe per node type, run through both packages --------
def _cyl(b, t):
    return b.new_cylinder(1.2, 2.0)


def _cyl_round(b, t):
    return b.new_cylinder(1.2, 2.0, 0.3)


def _translate(b, t):
    return b.translate(b.new_cylinder(0.7, 1.5, 0.1), 0.3, -0.2, 0.5)


def _scale(b, t):
    return b.scale(b.new_cylinder(0.7, 1.5, 0.1), 2.5)


def _difference(b, t):
    return b.difference(b.new_cylinder(1.0, 2.0), b.new_cylinder(0.5, 3.0))


def _intersection(b, t):
    return b.intersection(
        b.new_cylinder(1.0, 2.0), b.translate(b.new_cylinder(0.8, 2.0), 0.5, 0, 0.4)
    )


def _smooth_union(b, t):
    return b.smooth_union(
        0.3, b.new_cylinder(1.0, 1.0), b.translate(b.new_cylinder(0.5, 2.0), 0.8, 0, 0)
    )


def _opunion(b, t):
    hole = b.new_cylinder(0.2, 3.0)
    parts = [b.new_cylinder(1.5, 0.5)]
    parts += [b.translate(hole, np.cos(a), np.sin(a), 0) for a in np.linspace(0, 6, 7)]
    parts += [b.translate(b.new_cylinder(0.3, 1.0), 0, 0, 1.0)]
    return b.union(*parts)


def _polygon_small(b, t):
    return b.new_polygon([[0.0, 0.0], [1.0, 0.1], [0.8, 0.9], [0.2, 1.1], [-0.3, 0.5]])


def _polygon_scan(b, t):
    a = np.linspace(0, 2 * np.pi, 13)[:-1]
    r = 1.0 + 0.3 * np.cos(3 * a)
    return b.new_polygon(np.stack([r * np.cos(a), r * np.sin(a)], axis=1))


def _screw(b, t):
    return t.screw(b, 2.0, t.ISO(d=2.0, p=0.4, ext=True))


def _screw_npt(b, t):
    npt = t.NPT()
    npt.set_from_nominal(0.5)
    return t.screw(b, 0.8, npt)


def _sq(b):
    return b.new_rectangle(0.8, 0.5)


# parameters from the JAX package's own tests (test_primitives3.py,
# test_primitives2.py, test_ops.py) where they have them
NEW_CASES = {
    "Sphere": lambda b, t: b.new_sphere(0.7),
    "BoxShape": lambda b, t: b.new_box(1.0, 0.61, 0.42, 0.0),
    "BoxShape-rounded": lambda b, t: b.new_box(1.0, 0.61, 0.42, 0.05),
    "BoxFrame": lambda b, t: b.new_box_frame(1.0, 0.8, 0.6, 0.1),
    "Torus": lambda b, t: b.new_torus(1.0, 0.3),
    "HexagonalPrism": lambda b, t: b.new_hexagonal_prism(0.6, 0.4),
    "TriangularPrism": lambda b, t: b.new_triangular_prism(0.5, 0.8),
    "Circle": lambda b, t: b.new_circle(0.8),
    "Line2D": lambda b, t: b.new_line2d(-0.4, -0.2, 0.5, 0.35, 0.1),
    "Lines2D": lambda b, t: b.new_lines2d([[(-0.5, 0), (0, 0.3)], [(0, 0.3), (0.5, -0.2)]], 0.08),
    "Arc2D": lambda b, t: b.new_arc(0.6, np.pi / 1.5, 0.08),
    "EquilateralTriangle": lambda b, t: b.new_equilateral_triangle(0.6),
    "Rectangle": lambda b, t: b.new_rectangle(1.0, 0.6),
    "Hexagon2D": lambda b, t: b.new_hexagon(0.5),
    "Octagon2D": lambda b, t: b.new_octagon(0.7),
    "Ellipse2D": lambda b, t: b.new_ellipse(0.8, 0.45),
    "Diamond2D": lambda b, t: b.new_diamond2d(1.0, 0.6),
    "RoundedX2D": lambda b, t: b.new_rounded_x(1.0, 0.1),
    "QuadraticBezier2D": lambda b, t: b.new_quadratic_bezier2d(
        (-0.5, -0.2), (0.1, 0.6), (0.6, -0.1), 0.1
    ),
    "Xor": lambda b, t: b.xor(b.new_sphere(0.7), b.translate(b.new_box(1, 0.6, 0.5, 0), 0.4, 0, 0)),
    "SmoothDifference": lambda b, t: b.smooth_difference(
        0.2, b.new_box(1, 0.8, 0.6, 0), b.new_sphere(0.5)
    ),
    "SmoothIntersect": lambda b, t: b.smooth_intersect(
        0.2, b.new_box(1, 0.8, 0.6, 0), b.new_sphere(0.6)
    ),
    "Symmetry": lambda b, t: b.symmetry(
        b.translate(b.new_sphere(0.4), 0.5, 0.2, 0.1), True, False, True
    ),
    "Transform": lambda b, t: b.rotate(b.new_box(1.0, 0.6, 0.4, 0.05), 0.7, (1, 0.3, 0.2)),
    "Offset": lambda b, t: b.offset(b.new_box(1, 0.8, 0.6, 0), -0.05),
    "Array": lambda b, t: b.array(b.new_sphere(0.3), 0.8, 0.9, 0.7, 3, 2, 2),
    "Elongate": lambda b, t: b.elongate(b.new_sphere(0.4), 0.3, 0.2, 0.5),
    "Shell": lambda b, t: b.shell(b.new_sphere(0.6), 0.05),
    "CircularArray": lambda b, t: b.circular_array(
        b.translate(b.new_box(0.3, 0.2, 0.5, 0), 1.0, 0, 0), 5, 7
    ),
    "Twist": lambda b, t: b.twist(b.new_box(1.2, 0.4, 1.0, 0), 0.8),
    "OpUnion2D": lambda b, t: b.union2d(
        b.new_circle(0.4), b.translate2d(_sq(b), 0.3, 0.1), b.new_hexagon(0.3)
    ),
    "Difference2D": lambda b, t: b.difference2d(_sq(b), b.new_circle(0.2)),
    "Intersection2D": lambda b, t: b.intersection2d(_sq(b), b.new_circle(0.35)),
    "Xor2D": lambda b, t: b.xor2d(_sq(b), b.translate2d(b.new_circle(0.3), 0.2, 0)),
    "Extrusion": lambda b, t: b.extrude(b.new_hexagon(0.5), 0.8),
    "Revolution": lambda b, t: b.revolve(b.translate2d(b.new_rectangle(0.4, 0.6), 0.8, 0), 0.1),
    "Array2D": lambda b, t: b.array2d(b.new_circle(0.2), 0.5, 0.6, 3, 2),
    "Offset2D": lambda b, t: b.offset2d(_sq(b), -0.05),
    "Translate2D": lambda b, t: b.translate2d(b.new_hexagon(0.4), 0.2, -0.3),
    "Rotation2D": lambda b, t: b.rotate2d(_sq(b), 0.6),
    "Symmetry2D": lambda b, t: b.symmetry2d(b.translate2d(b.new_circle(0.3), 0.4, 0.2), True, True),
    "Annulus2D": lambda b, t: b.annulus(b.new_circle(0.6), 0.1),
    "CircularArray2D": lambda b, t: b.circular_array2d(
        b.translate2d(b.new_rectangle(0.3, 0.2), 0.8, 0), 5, 6
    ),
    "Scale2D": lambda b, t: b.scale2d(b.new_hexagon(0.4), 1.7),
    "TranslateMulti2D": lambda b, t: b.translate_multi2d(
        b.new_circle(0.2), [(0, 0), (0.5, 0.1), (-0.3, 0.4)]
    ),
    "Elongate2D": lambda b, t: b.elongate2d(b.new_circle(0.3), 0.4, 0.2),
    "BoundsOverride3": lambda b, t: t.with_bounds(
        b.new_sphere(0.7), t.Box([-0.5, -0.6, -0.7], [0.6, 0.5, 0.4])
    ),
    "BoundsOverride2": lambda b, t: t.with_bounds(b.new_circle(0.7), t.Box([-0.5, -0.6], [0.6, 0.5])),
}

NODE_CASES = {
    "Cylinder": _cyl,
    "Cylinder-rounded": _cyl_round,
    "Translate": _translate,
    "Scale": _scale,
    "Difference": _difference,
    "Intersection": _intersection,
    "SmoothUnion": _smooth_union,
    "OpUnion": _opunion,
    "Polygon2D-broadcast": _polygon_small,
    "Polygon2D-scan": _polygon_scan,
    "ScrewNode": _screw,
    "ScrewNode-tapered": _screw_npt,
    **NEW_CASES,
}


def _kit(threads, with_bounds, box):
    """What a recipe reaches besides the Builder: the package's threads
    module, with_bounds and Box."""
    return types.SimpleNamespace(
        **{n: getattr(threads, n) for n in threads.__all__}, with_bounds=with_bounds, Box=box
    )


JAX_KIT = _kit(jax_threads, jax_with_bounds, JaxBox)
TORCH_KIT = _kit(torch_threads, torch_with_bounds, TorchBox)


def both(recipe):
    return recipe(JaxBuilder(), JAX_KIT), recipe(TorchBuilder(), TORCH_KIT)


@pytest.mark.parametrize("case", list(NODE_CASES))
def test_node_distance_matches_jax(case):
    jnode, tnode = both(NODE_CASES[case])
    assert type(tnode).__qualname__ == type(jnode).__qualname__
    assert tnode.tree_hash() == jnode.tree_hash()
    p = points(jnode)
    np.testing.assert_allclose(
        torch_distance(tnode, p), jax_distance(jnode, p), rtol=RTOL, atol=ATOL
    )


PARTS = ["flange", "showerhead", "bolt", "knurled"]


def _parts(name):
    return (
        getattr(jax_flagships, f"build_{name}")(),
        getattr(torch_flagships, f"build_{name}")(),
    )


@pytest.mark.parametrize("name", PARTS)
def test_golden_part_hash_and_distance(name):
    jtree, ttree = _parts(name)
    assert ttree.tree_hash() == jtree.tree_hash()
    assert ttree.node_count() == jtree.node_count()
    p = points(jtree, seed=1)
    np.testing.assert_allclose(
        torch_distance(ttree, p), jax_distance(jtree, p), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("name", PARTS)
def test_from_reference_tree(name):
    jtree, ttree = _parts(name)
    conv = from_reference_tree(jtree)
    assert conv.tree_hash() == jtree.tree_hash() == ttree.tree_hash()
    p = points(jtree, n=1024, seed=2)
    # the converted tree is the port's own tree: bit-identical distances
    np.testing.assert_array_equal(torch_distance(conv, p), torch_distance(ttree, p))


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_from_reference_tree_recipe(case):
    jnode, tnode = both(NEW_CASES[case])
    conv = from_reference_tree(jnode)
    assert conv.tree_hash() == jnode.tree_hash()
    p = points(jnode, n=1024, seed=2)
    np.testing.assert_array_equal(torch_distance(conv, p), torch_distance(tnode, p))


def test_from_reference_tree_keeps_int_and_bool_params():
    """Ints and bools hash as 8-byte integers in the JAX package; a float32
    cast would change the tree hash the codegen names functions by."""
    jb = JaxBuilder()
    box = jb.new_box(0.3, 0.2, 0.5, 0.0)
    jtree = jb.union(
        jb.circular_array(jb.translate(box, 1.0, 0, 0), 5, 7),
        jb.symmetry(jb.translate(box, 0.5, 0.2, 0.1), True, False, True),
        jb.array(box, 0.8, 0.9, 0.7, 3, 2, 2),
    )
    conv = from_reference_tree(jtree)
    circ, sym, arr = conv.joined
    assert type(circ.n_inst) is int and type(circ.circle_div) is int
    assert type(sym.mx_) is bool and type(sym.mz_) is bool
    assert (type(arr.nx), type(arr.ny), type(arr.nz)) == (int, int, int)
    assert conv.tree_hash() == jtree.tree_hash()


def test_from_reference_tree_fills_derived_attributes():
    """Transform's inverse and BoundsOverride's box come back with the
    parameters (the distance reads only t_inv)."""
    jb = JaxBuilder()
    jtree = jax_with_bounds(jb.rotate(jb.new_box(1, 0.6, 0.4, 0), 0.7, (1, 0.3, 0.2)),
                            JaxBox([-1, -1, -1], [1, 1, 0.5]))
    conv = from_reference_tree(jtree)
    np.testing.assert_array_equal(conv.s.t_inv, jtree.s.t_inv)
    np.testing.assert_array_equal(conv.bounds().min, jtree.bounds().min)
    np.testing.assert_array_equal(conv.bounds().max, jtree.bounds().max)


class _Unported(JaxShader3D):
    """A node type the port does not have."""

    def distance(self, p):  # pragma: no cover - never evaluated
        raise NotImplementedError


def test_from_reference_tree_rejects_unported_node():
    jb = JaxBuilder()
    with pytest.raises(NotImplementedError, match="_Unported"):
        from_reference_tree(jb.union(_Unported(), jb.new_cylinder(1.0, 1.0)))


def _jax_node_classes():
    from gsdf_tpu.core import node, ops2, ops3, primitives2, primitives3, wrappers
    from gsdf_tpu.forge.threads.core import ScrewNode

    out = {ScrewNode}
    for mod in (primitives3, primitives2, ops3, ops2, wrappers):
        out |= {
            c for c in vars(mod).values()
            if isinstance(c, type) and issubclass(c, node.Shader) and c.__module__ == mod.__name__
        }
    return sorted(out, key=lambda c: c.__qualname__)


def test_every_jax_node_type_is_ported():
    """Same qualname, PARAMS and CHILDREN, and a CUDA emitter, for each of
    the JAX package's node classes; each has a parity recipe above."""
    from gsdf_tpu_torch.core.node import Shader

    jax_classes = _jax_node_classes()
    assert len(jax_classes) == 55
    assert set(NODE_TYPES) == {c.__qualname__ for c in jax_classes}
    covered = set()
    for recipe in NODE_CASES.values():
        covered |= {type(n).__qualname__ for n in both(recipe)[1].visit_bfs()}
    for jcls in jax_classes:
        cls = NODE_TYPES[jcls.__qualname__]
        assert cls.PARAMS == jcls.PARAMS and cls.CHILDREN == jcls.CHILDREN, cls
        assert cls.emit_cuda is not Shader.emit_cuda, cls
        assert jcls.__qualname__ in covered, jcls


def test_visit_dfs_matches_jax():
    jtree, ttree = _parts("bolt")
    assert [type(n).__qualname__ for n in ttree.visit_dfs()] == [
        type(n).__qualname__ for n in jtree.visit_dfs()
    ]


def test_cbrt_is_accurate():
    """The port's cube root (shared by the plain version and the generated
    C) against numpy's: within 2 ulp (rtol 2.4e-7) over 60 decades; 0 and
    inf exact."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.logspace(-30, 30, 2001),
        rng.random(4096) * 10.0,
        [1.0, 8.0, 27.0, 0.125, 1e-3],
    ]).astype(np.float32)
    got = mx.cbrt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.cbrt(x.astype(np.float64)), rtol=2.4e-7, atol=0)
    special = mx.cbrt(torch.tensor([0.0, np.inf], dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(special, [0.0, np.inf])


def test_import_leaves_jax_out():
    code = (
        "import sys; import gsdf_tpu_torch, gsdf_tpu_torch.cli, "
        "gsdf_tpu_torch.convert, gsdf_tpu_torch.eval.grid_kernels; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gsdf_tpu.'))"
        " or m == 'gsdf_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_float_literals_round_trip():
    vals = np.float32([0.1, -1 / 3, 25.4, 1e-12, 3.4e38, 1e20, 0.0, 2.0])
    for v in vals:
        s = lit(v).strip("()").rstrip("f")
        assert np.float32(float(s)) == v
    assert lit(np.float32(np.inf)) == "INFINITY"


# --- the CUDA emitters, built by g++ on the CPU -------------------------
def _nine_type_tree(b, t):
    """All nine node types of the first slice in one tree."""
    body = b.smooth_union(0.2, _opunion(b, t), b.scale(_difference(b, t), 0.8))
    return b.union(b.intersection(body, b.new_cylinder(1.8, 1.8, 0.1)), _screw(b, t))


#: the recipes whose root is a 2D node
RECIPES_2D = [n for n, r in NODE_CASES.items() if r(TorchBuilder(), TORCH_KIT).NDIM == 2]


def _codegen_trees():
    """name -> torch tree: every recipe (2D ones extruded, and as the 2D
    root they are under "<name>/2d"), the golden parts, the nine-type tree
    and chip_smoke's every-type tree."""
    import chip_smoke

    trees = {}
    for name, recipe in NODE_CASES.items():
        tree = recipe(TorchBuilder(), TORCH_KIT)
        trees[name] = tree if tree.NDIM == 3 else TorchBuilder().extrude(tree, 0.9)
        if tree.NDIM == 2:
            trees[f"{name}/2d"] = tree
    for name in PARTS:
        trees[name] = _parts(name)[1]
    trees["nine-types"] = _nine_type_tree(TorchBuilder(), torch_threads)
    trees["every-type"] = chip_smoke.every_type_tree(
        TorchBuilder(), torch_threads, torch_with_bounds, TorchBox
    )
    return trees


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """One g++ build of every tree's generated source, each in its own
    namespace: {name: (tree, eval(p) -> distances)}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    d = tmp_path_factory.mktemp("codegen")
    trees = _codegen_trees()
    shim = ["#include <math.h>", "#include <stdint.h>", "#include <string.h>"]
    for i, tree in enumerate(trees.values()):
        (d / f"tree{i}.cuh").write_text(tree_source(tree))
        point = ", ".join(f"p[{tree.NDIM} * k + {c}]" for c in range(tree.NDIM))
        shim.append(
            f'namespace tree{i} {{\n#include "tree{i}.cuh"\n}}\n'
            f"static_assert(GSDF_NDIM == {tree.NDIM}, \"the source states its tree's NDIM\");\n"
            f'extern "C" void eval{i}(const float* p, float* out, long n) {{\n'
            f"    for (long k = 0; k < n; ++k)\n"
            f"        out[k] = tree{i}::gsdf_tree({point});\n}}"
        )
    (d / "shim.cpp").write_text("\n".join(shim) + "\n")
    so = d / "libshim.so"
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))

    def evaluator(i):
        fn = getattr(lib, f"eval{i}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        fn.restype = None

        def run(p):
            p = np.ascontiguousarray(p, np.float32)
            out = np.empty(len(p), np.float32)
            fn(p.ctypes.data, out.ctypes.data, len(p))
            return out

        return run

    return {name: (tree, evaluator(i)) for i, (name, tree) in enumerate(trees.items())}


@pytest.mark.parametrize("name", list(NODE_CASES) + PARTS + ["nine-types", "every-type"])
def test_codegen_matches_plain_torch(name, host_kernels):
    """Emitter bugs show here before any chip time: g++ builds the very
    source nvcc builds (no FMA contraction on either). The C library's
    transcendentals and torch's CPU sqrt may differ from each other by an
    ulp, so distances compare at atol=1e-5; their signs, which decide the
    MC cases, must agree."""
    tree, run = host_kernels[name]
    p = points(tree, seed=3)
    got = run(p)
    ref = torch_distance(tree, p)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got < 0, ref < 0)
    kinds = {type(n).__qualname__ for n in tree.visit_bfs()}
    if name == "nine-types":
        assert len(kinds) == 9, kinds
    if name == "every-type":
        assert kinds == set(NODE_TYPES), set(NODE_TYPES) - kinds


@pytest.mark.parametrize("name", RECIPES_2D)
def test_codegen_2d_root_matches_plain_torch(name, host_kernels):
    """A 2D root's generated source (`gsdf_tree(px, py)`, GSDF_NDIM 2), as
    the point kernel and the pixel-grid kernel build it, against plain
    torch at the same tolerance."""
    tree, run = host_kernels[f"{name}/2d"]
    assert tree.NDIM == 2 and "gsdf_tree(float px, float py)" in tree_source(tree)
    p = points(tree, seed=3)
    got = run(p)
    ref = torch_distance(tree, p)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got < 0, ref < 0)


def test_tree_source_states_ndim():
    for tree, ndim in ((TorchBuilder().new_sphere(1.0), 3), (TorchBuilder().new_circle(1.0), 2)):
        src = tree_source(tree)
        assert f"#define GSDF_NDIM {ndim}" in src
        assert ("float pz" in src.split("gsdf_tree(")[1].split(")")[0]) == (ndim == 3)


def test_every_type_tree_matches_jax():
    """chip_smoke's every-type tree, built through both packages."""
    import chip_smoke

    jtree = chip_smoke.every_type_tree(JaxBuilder(), jax_threads, jax_with_bounds, JaxBox)
    ttree = chip_smoke.every_type_tree(TorchBuilder(), torch_threads, torch_with_bounds, TorchBox)
    assert ttree.tree_hash() == jtree.tree_hash()
    p = points(jtree, seed=4)
    np.testing.assert_allclose(
        torch_distance(ttree, p), jax_distance(jtree, p), rtol=RTOL, atol=ATOL
    )


def test_builder_error_policy_matches_jax():
    """Invalid dimensions raise by default and accumulate for err() under
    NO_DIMENSION_PANIC, with the JAX package's messages."""
    from gsdf_tpu.core import Flags as JaxFlags
    from gsdf_tpu.core import ShapeError as JaxShapeError
    from gsdf_tpu_torch import Flags, ShapeError

    msgs = []
    for B, F, E in ((JaxBuilder, JaxFlags, JaxShapeError), (TorchBuilder, Flags, ShapeError)):
        with pytest.raises(E):
            B().new_cylinder(-1.0, 1.0)
        b = B(F.NO_DIMENSION_PANIC)
        assert b.err() is None
        b.new_cylinder(-1.0, 1.0)
        b.new_polygon([[0.0, 0.0], [1.0, 0.0]])
        err = b.err()
        assert isinstance(err, ExceptionGroup)
        msgs.append([str(e) for e in err.exceptions])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 3


def test_builder_flags_match_jax():
    """set_flags' shader-buffer check, clear_errors, formatted
    shape_error and the use_shader_buffer heuristic, as in the JAX
    package."""
    from gsdf_tpu.core import Flags as JaxFlags
    from gsdf_tpu_torch import Flags

    seen = []
    for B, F in ((JaxBuilder, JaxFlags), (TorchBuilder, Flags)):
        b = B()
        with pytest.raises(ValueError, match="shader buffer"):
            b.set_flags(F.USE_SHADER_BUFFERS | F.NO_SHADER_BUFFERS)
        b.set_flags(F.NO_DIMENSION_PANIC)
        assert b.flags == F.NO_DIMENSION_PANIC
        b.new_octagon(-1.0)
        msg = str(b.err())
        b.clear_errors()
        assert b.err() is None
        buffers = [b.use_shader_buffer(n) for n in (4, 200)]
        b.set_flags(F.USE_SHADER_BUFFERS)
        buffers.append(b.use_shader_buffer(4))
        b.set_flags(F.NO_SHADER_BUFFERS)
        buffers.append(b.use_shader_buffer(200))
        seen.append((msg, buffers))
    assert seen[0] == seen[1]
    assert seen[1][1] == [False, True, True, False]
