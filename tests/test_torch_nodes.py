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
import hashlib
import os
import re
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
from gsdf_tpu_torch.codegen.cuda import (Codegen, bin_table, lit, tree_loops, tree_sites,
                                         tree_source)
from gsdf_tpu_torch.convert import NODE_TYPES, from_reference_tree
from gsdf_tpu_torch.core import mathx as mx
from gsdf_tpu_torch.core.node import radial_at
from gsdf_tpu_torch.core.primitives2 import Polygon2D
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
    trees["geb"] = torch_flagships.build_geb()
    return trees


#: how a g++ build below takes each tree's short-circuit sites: as the
#: source defines them, all off (every Difference evaluates its subtrahend
#: and every union each member, the arithmetic of a source without sites),
#: or off and recording each site's `a` (the macro expands inside the
#: site's function: a Difference's minuend, a union's running minimum) and
#: a Difference's subtrahend `b` (a line the build adds after b's) or a
#: union member's point bound (a line the build adds before the site).
#: "off" and "record" also walk each threshold form's loop whole
#: (GSDF_TABLE false); "walk" is "on" and records the members each loop
#: walks (GSDF_LOOP)
SITE_MODES = {
    "on": "",
    "off": "#define GSDF_SITE(k, skip) false\n#define GSDF_TABLE(k, near) false\n",
    "record": "#define GSDF_SITE(k, skip) (gsdf_seen[2 * (k)] = a, false)\n"
              "#define GSDF_TABLE(k, near) false\n",
    "walk": "#define GSDF_LOOP(k, n) (gsdf_seen[k] = (float)(n))\n",
}


def _recording(src):
    """A baked source whose site functions also store their b, and whose
    union sites their member's bound."""
    src = re.sub(r"(if \(GSDF_SITE\((\d+), [^\n]*\)\) return a;\n( *)float b = [^\n]*\n)",
                 r"\1\3gsdf_seen[2 * \2 + 1] = b;\n", src)
    return re.sub(r"( *)if \((i == 1 && )?(!?)GSDF_SITE\(([^,]+), a < (lo\d*) && ",
                  r"\1if (\2true) gsdf_seen[2 * (\4) + 1] = \5;\n\1if (\2\3GSDF_SITE(\4, a < \5 && ",
                  src)


def _host_build(d, trees, modes=("on",)):
    """One g++ build of each tree's generated source in each of `modes`
    (SITE_MODES), each in its own namespace: {(name, mode): eval(p) ->
    distances}; "record" gives (n, sites, 2) minuends and subtrahends
    instead, NaN where a point did not reach a site, and "walk" (n, loops)
    the members each loop walked, NaN where a point did not enter it."""
    shim = ["#include <math.h>", "#include <stdint.h>", "#include <string.h>",
            "static float gsdf_seen[128];"]
    names = []
    for i, (name, tree) in enumerate(trees.items()):
        for mode in modes:
            j = len(names)
            names.append((name, mode))
            # a first line of its own: g++ takes two files of the same text
            # for one under #pragma once
            src = tree_source(tree)
            (d / f"tree{j}.cuh").write_text(f"// {name}, sites {mode}\n"
                                            + (_recording(src) if mode == "record" else src))
            point = ", ".join(f"p[{tree.NDIM} * k + {c}]" for c in range(tree.NDIM))
            n_sites = 2 * len(tree_sites(tree)) if mode == "record" else len(tree_loops(tree))
            if mode in ("record", "walk"):
                body = (f"for (int s = 0; s < {n_sites}; ++s) gsdf_seen[s] = NAN;\n"
                        f"        tree{j}::gsdf_tree({point});\n"
                        f"        for (int s = 0; s < {n_sites}; ++s) "
                        f"out[{n_sites} * k + s] = gsdf_seen[s];")
            else:
                body = f"out[k] = tree{j}::gsdf_tree({point});"
            shim.append(
                f"#undef GSDF_SITE\n#undef GSDF_TABLE\n#undef GSDF_LOOP\n{SITE_MODES[mode]}"
                f'namespace tree{j} {{\n#include "tree{j}.cuh"\n}}\n'
                f"static_assert(GSDF_NDIM == {tree.NDIM}, \"the source states its tree's NDIM\");\n"
                f'extern "C" void eval{j}(const float* p, float* out, long n) {{\n'
                f"    for (long k = 0; k < n; ++k) {{\n        {body}\n    }}\n}}"
            )
    (d / "shim.cpp").write_text("\n".join(shim) + "\n")
    so = d / "libshim.so"
    # fminf and fmaxf called in the source's operand order: as builtins g++
    # may swap the operands, and the libm functions return the second of
    # two zeros of either sign, so that two builds of one expression could
    # differ in a zero's sign
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-fno-builtin-fminf", "-fno-builtin-fmaxf",
         "-std=c++17", "-shared", "-fPIC", "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))

    def evaluator(j, width):
        fn = getattr(lib, f"eval{j}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        fn.restype = None

        def run(p):
            p = np.ascontiguousarray(p, np.float32)
            out = np.empty((len(p), *width), np.float32)
            fn(p.ctypes.data, out.ctypes.data, len(p))
            return out

        return run

    widths = {"record": lambda t: (len(tree_sites(t)), 2), "walk": lambda t: (len(tree_loops(t)),)}
    return {(name, mode): evaluator(j, widths[mode](trees[name]) if mode in widths else ())
            for j, (name, mode) in enumerate(names)}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """One g++ build of every tree's generated source, each in its own
    namespace: {name: (tree, eval(p) -> distances)}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    trees = _codegen_trees()
    runs = _host_build(tmp_path_factory.mktemp("codegen"), trees)
    return {name: (tree, runs[name, "on"]) for name, tree in trees.items()}


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


class _DividingPolygon2D(Polygon2D):
    """A Polygon2D whose emitted edge loop divides at every edge, as the
    loop did before its division went behind the clamp: the oracle of the
    emitted C where the plain's quotient is NaN (the plain's torch.clamp
    and torch.minimum carry a NaN on, fminf and fmaxf drop it)."""

    def emit_cuda(self, cg) -> str:
        edges = self._edges()
        arr = cg.array(self, edges)
        return (
            "float d = INFINITY;\n"
            "int nflips = 0;\n"
            f"for (int e = 0; e < {len(edges)}; ++e) {{\n"
            f"    const float* v = {arr} + 4 * e;\n"
            "    float ex = v[2] - v[0];\n"
            "    float ey = v[3] - v[1];\n"
            "    float wx = px - v[0];\n"
            "    float wy = py - v[1];\n"
            "    float ee = ex * ex + ey * ey;\n"
            "    float h = fminf(fmaxf((wx * ex + wy * ey) / ee, 0.0f), 1.0f);\n"
            "    float bx = wx - h * ex;\n"
            "    float by = wy - h * ey;\n"
            "    d = fminf(d, bx * bx + by * by);\n"
            "    bool b1 = py >= v[1];\n"
            "    bool b2 = py < v[3];\n"
            "    bool b3 = ex * wy > ey * wx;\n"
            "    nflips += ((b1 && b2 && b3) || (!b1 && !b2 && !b3)) ? 1 : 0;\n"
            "}\n"
            "return ((nflips % 2 == 1) ? -1.0f : 1.0f) * sqrtf(d);"
        )


#: polygons at the edge loop's corners besides the two recipes: a repeated
#: vertex (ee = 0, num = 0 everywhere), an edge whose ee underflows to 0
#: while num need not be 0, and edges whose ee overflows to +inf
EDGE_POLYGONS = {
    "repeated-vertex": [[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.5, 1.0]],
    "underflow-edge": [[0.0, 0.0], [1e-30, 0.0], [1.0, 0.5], [0.0, 1.0]],
    "huge-vertices": [[-1e20, -1e20], [1e20, -1e20], [0.0, 1e20]],
}


def _edge_num(edges, p):
    """(N, V) float32 num = wx ex + wy ey of each point at each edge, and
    (V,) ee, in the plain's float32 operations."""
    v1x, v1y, v2x, v2y = (edges[:, i] for i in range(4))
    with np.errstate(all="ignore"):
        ex, ey = v2x - v1x, v2y - v1y
        ee = ex * ex + ey * ey
        wx, wy = p[:, :1] - v1x, p[:, 1:] - v1y
        return wx * ex + wy * ey, ee


def _edge_points(poly):
    """Adversarial points of a polygon's edge loop: random points of its
    box, its vertices, its edges' midpoints, points on each edge's
    perpendiculars through its two ends at which num is exactly 0 or
    exactly ee (py stepped ulp by ulp), NaN and infinite coordinates,
    large, tiny and signed-zero ones."""
    f = np.float32
    edges = poly._edges()
    out = [points(poly, n=256, seed=7), poly.vert, (edges[:, :2] + edges[:, 2:]) * f(0.5)]
    steps = np.arange(-64, 65, dtype=np.int32)
    with np.errstate(all="ignore"):
        for v1x, v1y, v2x, v2y in edges:
            ex, ey = v2x - v1x, v2y - v1y
            for x0, y0, exact in ((v1x, v1y, "zero"), (v2x, v2y, "ee")):
                for s in f([0.25, 0.5, 1.0, 1.5, 3.0]):
                    px, py0 = x0 - s * ey, y0 + s * ex
                    if not np.isfinite(px) or not np.isfinite(py0) or py0 == 0:
                        continue
                    py = (np.full(steps.shape, py0).view(np.int32) + steps).view(f)
                    cand = np.stack([np.full(py.shape, px), py], axis=1)
                    num, ee = _edge_num(np.stack([[v1x, v1y, v2x, v2y]]), cand)
                    out.append(cand[num[:, 0] == (0 if exact == "zero" else ee[0])])
    inf, nan = np.inf, np.nan
    out.append(np.array([[nan, 0], [0, nan], [nan, nan], [inf, 0], [-inf, 0], [0, inf],
                         [0, -inf], [inf, inf], [inf, -inf], [-inf, inf], [-inf, -inf],
                         [inf, nan], [1e20, 3e19], [-3e38, 1e38], [1e30, -1e30],
                         [3.4e38, 3.4e38], [1e-40, -1e-40], [-0.0, -0.0], [0.0, -0.0]], f))
    return np.concatenate(out).astype(f)


@pytest.fixture(scope="module")
def edge_loops(tmp_path_factory):
    """The two Polygon2D recipes and EDGE_POLYGONS as 2D roots, each emitted
    as now and with the loop that divides at every edge
    (_DividingPolygon2D), built by g++: {name: (polygon, now, before)}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    polys = {name: NODE_CASES[name](TorchBuilder(), TORCH_KIT)
             for name in ("Polygon2D-broadcast", "Polygon2D-scan")}
    polys.update({name: Polygon2D(v) for name, v in EDGE_POLYGONS.items()})
    trees = {}
    for name, poly in polys.items():
        trees[name], trees[f"{name}/before"] = poly, _DividingPolygon2D(poly.vert)
    runs = _host_build(tmp_path_factory.mktemp("edges"), trees)
    return {name: (poly, runs[name, "on"], runs[f"{name}/before", "on"])
            for name, poly in polys.items()}


@pytest.mark.parametrize("name", ["Polygon2D-broadcast", "Polygon2D-scan", *EDGE_POLYGONS])
def test_edge_loop_bit_equal_at_adversarial_points(name, edge_loops):
    """The emitted edge loop, which divides only where 0 < num < ee, equals
    the loop that divides at every edge bit for bit at every adversarial
    point (_edge_points), and the plain Polygon2D bit for bit wherever the
    plain gives no NaN: the recipes at every point with finite coordinates.
    The points reach all three ways of an edge: num <= 0 or NaN, num >= ee,
    and the division between; and num == 0 and num == ee exactly."""
    poly, now, before = edge_loops[name]
    assert "GSDF_EDGE(0, num > 0.0f && " in tree_source(poly)
    assert ("isinf(ee)" in tree_source(poly)) == (name == "huge-vertices")
    p = _edge_points(poly)
    num, ee = _edge_num(poly._edges(), p)
    shortcut = (num <= 0) | np.isnan(num) | (num >= ee)
    assert (num == 0).any() and (num == ee).any() and (num >= ee).any()
    assert (num <= 0).any() and np.isnan(num).any()
    assert (~shortcut).any() or name == "repeated-vertex"
    got, old, ref = now(p), before(p), torch_distance(poly, p)
    np.testing.assert_array_equal(got.view(np.uint32), old.view(np.uint32))
    plain = ~np.isnan(ref)
    np.testing.assert_array_equal(got[plain].view(np.uint32), ref[plain].view(np.uint32))
    if name.startswith("Polygon2D"):
        assert plain[np.isfinite(p).all(axis=1)].all()


def test_tree_source_states_ndim():
    for tree, ndim in ((TorchBuilder().new_sphere(1.0), 3), (TorchBuilder().new_circle(1.0), 2)):
        src = tree_source(tree)
        assert f"#define GSDF_NDIM {ndim}" in src
        assert ("float pz" in src.split("gsdf_tree(")[1].split(")")[0]) == (ndim == 3)


# --- short circuits: a Difference skips a subtrahend that cannot change it
#: sha256 (first 16 hex digits) of each codegen tree's source (baked,
#: parametric) as it was before short circuits, with each polygon's edge
#: loop as it is now (EDGE_LOOP_BEFORE: the trees with a Polygon2D before
#: their loop divided only where the clamp does not decide). A baked source
#: with sites must read so with its site lines taken out; every other
#: source as it is.
SOURCE_HASHES = {
    "Cylinder": ("10f03a176ff868ed", "0ac1f57f098c1cfb"),
    "Cylinder-rounded": ("581c0ba9ce743605", "212b7271e9dbcb2e"),
    "Translate": ("6ddeceb1529f7646", "027c79dcda555e4c"),
    "Scale": ("eea162617730c004", "226927bd42fc949e"),
    "Difference": ("2dda975da557b026", "601dcf18c2fe1fb4"),
    "Intersection": ("52b7af794499bc82", "ba5dd21fcd1750ee"),
    "SmoothUnion": ("2595fa82a8dc58cf", "e9106160bc2f1089"),
    "OpUnion": ("83beae3e616087d3", "f553600a12c91738"),
    "Polygon2D-broadcast": ("6f72f121ec0a82e0", "9f6de220867c75df"),
    "Polygon2D-broadcast/2d": ("59ce07387e4d288c", "41870dc3063cd1b4"),
    "Polygon2D-scan": ("e32c5e6534bc58cf", "33934bf68b4a9f36"),
    "Polygon2D-scan/2d": ("071cd4c21ddd9b01", "b12c4a2994e83533"),
    "ScrewNode": ("d36f5236b1589314", "101c7b265fef9f63"),
    "ScrewNode-tapered": ("a912dda35687803b", "c6f9cd6ecb1997c5"),
    "Sphere": ("561b08d40fa6e5dd", "02be0c2b6d03c1ec"),
    "BoxShape": ("706b113d82a8d86f", "20d16226157d0066"),
    "BoxShape-rounded": ("6c5127a733c1123a", "20d16226157d0066"),
    "BoxFrame": ("ff31fd21bf0f7794", "0a2a021e8e6c2bc9"),
    "Torus": ("ed0fdd87d50aa39d", "1c6935cf8f9b1fec"),
    "HexagonalPrism": ("75679a206deae8bf", "aea1164040e1aba2"),
    "TriangularPrism": ("92f829f70f079fd8", "a2f8b2ee3f8fc805"),
    "Circle": ("2ad6ff16d759c26e", "dcf6f50923802bcd"),
    "Circle/2d": ("b80a1b8e99afe037", "cab531aed5d1e33f"),
    "Line2D": ("fa82b9948fa14236", "8e72c1264c977889"),
    "Line2D/2d": ("b02154a1a6329e3d", "635d4c113b96f740"),
    "Lines2D": ("99bcda60860b812d", "6a506523c069e5e7"),
    "Lines2D/2d": ("83945deedc1c9a0e", "d79317835f99a570"),
    "Arc2D": ("579b2726efc84157", "ff56f789e70c9899"),
    "Arc2D/2d": ("b79daf86f1df7600", "cc9102ef17067966"),
    "EquilateralTriangle": ("5510ef7685affe77", "a2f8b2ee3f8fc805"),
    "EquilateralTriangle/2d": ("39c565020b81f9ae", "b8a69da244193e48"),
    "Rectangle": ("ba72d1523556be99", "29780d8e1b6264db"),
    "Rectangle/2d": ("267f9652d30c7dfa", "5ea0c324ae0544d2"),
    "Hexagon2D": ("cb007235d3b74d44", "dd39a00096bd21c1"),
    "Hexagon2D/2d": ("40d89fb469c68f9a", "1564599cc7565df5"),
    "Octagon2D": ("b85dcb95b63850cf", "9c081e01a160d65d"),
    "Octagon2D/2d": ("35823dfba8e30d2a", "3fc4e95be902ddfe"),
    "Ellipse2D": ("094f3d1f3e4d0502", "5caaaa12e4599ccd"),
    "Ellipse2D/2d": ("f017dce0dbf450ab", "6cf5b282d1c43df8"),
    "Diamond2D": ("8b77c858a0a24b45", "724ee43cff814af2"),
    "Diamond2D/2d": ("ca5bb3e35bda1c54", "3a0a8e6b348cd6f8"),
    "RoundedX2D": ("daaa112e45ac9956", "3e9821d1259c8775"),
    "RoundedX2D/2d": ("dbdd918b4c8be839", "a9485cc538af703d"),
    "QuadraticBezier2D": ("3eb56ca6da9e081d", "a50e40d8e7cf5307"),
    "QuadraticBezier2D/2d": ("eaa92dcd8aec71f1", "b4ebc2c141609595"),
    "Xor": ("6b22bb995f2d20e5", "15153e35af3ba7c5"),
    "SmoothDifference": ("f93b5956573c9928", "2836912ae9ea7c88"),
    "SmoothIntersect": ("26f5ff82d02b276d", "cb39a206c8174afc"),
    "Symmetry": ("240d799d0e2490a6", "12a7cc23cf40e3b0"),
    "Transform": ("7401c421b65aac58", "ca4f01d3850789cd"),
    "Offset": ("0327f397fc9b3444", "775aa846ac31bb13"),
    "Array": ("9196a1e884add69d", "e99dc7161e66342b"),
    "Elongate": ("fbefbb1124076363", "fcdd45b1b4bd19ec"),
    "Shell": ("7dcabb3a44c5742e", "521a9ef1baa05bfa"),
    "CircularArray": ("56fa02999b000a46", "8707866dc26e412a"),
    "Twist": ("1f63f8f6835704ec", "4f6582eece876664"),
    "OpUnion2D": ("3aebef064acd1d19", "d1767e23b7121083"),
    "OpUnion2D/2d": ("1c78c8dcc0e380df", "8c866350f4f4d934"),
    "Difference2D": ("872e9ee194daac5b", "009cf1d0c15b3b5e"),
    "Difference2D/2d": ("808aa67c7f9a9cd3", "d2251ee1236c6ea1"),
    "Intersection2D": ("e1f44766f1b27488", "807963c88d5ce9bc"),
    "Intersection2D/2d": ("f4eae5c0c89da232", "9c4795cf5b81ec4e"),
    "Xor2D": ("fcce3df6b6da2c44", "72619499923b1378"),
    "Xor2D/2d": ("5a225c2e735dbc68", "015a0d66b7ca8b1f"),
    "Extrusion": ("916b62dbdd2fea46", "dd39a00096bd21c1"),
    "Revolution": ("f9e19d9bf7f9b894", "a03ab30ec7b54fae"),
    "Array2D": ("7adf64facff9c95f", "879e4aa89f78c64a"),
    "Array2D/2d": ("37c390e2a133e49b", "b335b5ea0e3bc4b9"),
    "Offset2D": ("b12c341c85577566", "39b94b82dada0514"),
    "Offset2D/2d": ("7e985b31bd96d079", "50abe48b53017a57"),
    "Translate2D": ("5a538a712dd072b7", "483256383f683034"),
    "Translate2D/2d": ("26ca0a776d702692", "6896ff4ef09224e2"),
    "Rotation2D": ("f85cef30532b9271", "baad40d25e6553e4"),
    "Rotation2D/2d": ("c878496be90239d5", "d55ff847964ef5a4"),
    "Symmetry2D": ("ad09eaad457315cc", "bb9fdbaef4553da5"),
    "Symmetry2D/2d": ("e6794e7057236115", "2bb65a776ecd5bbb"),
    "Annulus2D": ("852a0cf0ac9258fb", "dc1cb120628eab50"),
    "Annulus2D/2d": ("ca1f82dc0844b77f", "78edd2892a332d55"),
    "CircularArray2D": ("3594676cea57f97d", "c5f30fdabcb96ca0"),
    "CircularArray2D/2d": ("8ce17a7a2cd3a325", "ac6cd8516dff68ef"),
    "Scale2D": ("e4cc3a297b832418", "3ec82fe68775e5ba"),
    "Scale2D/2d": ("be47e30b08e9a0d8", "53e5a5432224fb0e"),
    "TranslateMulti2D": ("a1ea15bd9e1b08e1", "a1e4c5258bc94947"),
    "TranslateMulti2D/2d": ("8fe1bde947c09c78", "653ee9d8021e9b75"),
    "Elongate2D": ("fe45f9c18fec754d", "b6bb45bf72d36efd"),
    "Elongate2D/2d": ("4c3e5ced39c3acc6", "33c411c1c42f7022"),
    "BoundsOverride3": ("80212f680c140e8c", "07352b39e1a796f0"),
    "BoundsOverride2": ("2bb67452fdaecd74", "0969c1ad56e02e49"),
    "BoundsOverride2/2d": ("a8ec44fd267b0aa3", "cc0843b3a009585d"),
    "flange": ("11e4f2361daa0f5c", "1ca24b1a66bd50c6"),
    "showerhead": ("73e6fb7a1923a757", "940fb4f67356cd76"),
    "bolt": ("b981e77cd4633dce", "91629d5ba9eab1bf"),
    "knurled": ("be0af495114e2bb7", "3b9ff7918baa2964"),
    "nine-types": ("716e7eb13d25d401", "6bd7646ea04c91e2"),
    "every-type": ("bcab8a06caf61801", "2dcdcb5cb860f9c4"),
    "geb": ("7893a2073e2fdd25", "926641c3ee449830"),
}


#: SOURCE_HASHES' entries of the trees with a Polygon2D before the edge
#: loop divided only where the clamp does not decide h
EDGE_LOOP_BEFORE = {
    "Polygon2D-broadcast": ("5efb84a3055c5e90", "b8813c5ea154903e"),
    "Polygon2D-broadcast/2d": ("e0b636e2cab04022", "f2168c438ab78257"),
    "Polygon2D-scan": ("ad9fc95c219c1d45", "013effcd17484222"),
    "Polygon2D-scan/2d": ("ce221994cc9b036c", "8a217d76fbbe4e6e"),
    "ScrewNode": ("191cf7400db9036a", "acc98ca85ddb47b2"),
    "ScrewNode-tapered": ("27ff3e2ab622a891", "f2b1b0045ee3b294"),
    "flange": ("d63a7184aab939ea", "ed705940a69c8174"),
    "showerhead": ("8fa0c8b449602bcd", "0fc4cae09fd54662"),
    "bolt": ("cca51a5a82f33a38", "278f62f80189703e"),
    "nine-types": ("d907d8e881c26278", "ee7f337c7fe46d4d"),
    "every-type": ("97f575bfd40c6d68", "f02c74e35ab23b17"),
    "geb": ("b5ef4e9f45079856", "1338a43df52b676c"),
}


def _without_sites(src):
    """A baked source with its short-circuit lines taken out: the site
    macros after the prelude and each Difference's early return."""
    src = re.sub(r"#undef GSDF_NSITES\n#define GSDF_NSITES \d+\n#ifndef GSDF_SITE\n"
                 r"#define GSDF_SITE\(k, skip\) \(skip\)\n#endif\n", "", src)
    return re.sub(r" *if \(GSDF_SITE\(\d+, a > [^\n]*\)\) return a;\n", "", src)


def _digest(text):
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@pytest.fixture(scope="module")
def codegen_trees():
    return _codegen_trees()


@pytest.mark.parametrize("name", list(SOURCE_HASHES))
def test_source_unchanged_but_for_sites(name, codegen_trees, monkeypatch):
    """A tree with no Difference over a bounded subtrahend and no union
    member with a point bound emits the same text as before, and so does
    every tree in parametric mode (its bounds would depend on the
    parameter vector); a tree with Difference sites differs only by their
    lines. A tree with union sites emits the text of before where no class
    states a point bound."""
    tree = codegen_trees[name]
    baked, parametric = SOURCE_HASHES[name]
    src = tree_source(tree)
    assert _digest(tree_source(tree, parametric=True)) == parametric
    assert "GSDF_SITE" not in tree_source(tree, parametric=True)
    sites = tree_sites(tree)
    unions = [site for site, _, lo in sites if lo is None]
    assert ("GSDF_SITE" in src) == bool(sites)
    assert src.count("if (GSDF_SITE(") == len(sites) - len(unions)
    if sites:
        assert f"#define GSDF_NSITES {len(sites)}\n" in src
    if unions:
        assert src.count("_lo(float px, float py, float pz) {") >= 1
        monkeypatch.setattr(Codegen, "point_bound", lambda self, node: None)
        assert tree_sites(tree) == [site for site in sites if site[2] is not None]
        src = tree_source(tree)
    assert "_lo(" not in src
    assert _digest(_without_sites(src)) == baked


@pytest.mark.parametrize("name", list(SOURCE_HASHES))
def test_edge_loop_changed_only_polygon_sources(name, codegen_trees):
    """The edge loop changed the sources of the trees with a Polygon2D, in
    both modes, and of no other tree: a polygon-free tree (the knurled
    part's among them) keeps its SOURCE_HASHES entry of before, which
    test_source_unchanged_but_for_sites holds."""
    tree = codegen_trees[name]
    polygon = any(type(n).__name__ == "Polygon2D" for n in tree.visit_bfs())
    assert polygon == (name in EDGE_LOOP_BEFORE)
    assert (name == "knurled") <= (not polygon)
    for src in (tree_source(tree), tree_source(tree, parametric=True)):
        assert ("GSDF_EDGES(0);" in src) == polygon
        assert ("#define GSDF_NPOLYGONS" in src) == polygon
    if polygon:
        assert all(a != b for a, b in zip(SOURCE_HASHES[name], EDGE_LOOP_BEFORE[name]))


#: trees whose root declares a finite lower bound beyond NODE_CASES' own:
#: a 2D union and translate of bounded children, a hole plate
BOUND_CASES = {
    "OpUnion2D-bounded": lambda b, t: b.union2d(
        b.new_circle(0.4), b.translate2d(_sq(b), 0.3, 0.1), b.new_circle(0.2)
    ),
    "Translate2D-bounded": lambda b, t: b.translate2d(b.new_circle(0.4), 0.2, -0.3),
    "Intersection-screw": lambda b, t: b.intersection(_screw(b, t), b.new_sphere(1.0)),
}


def _bound_trees():
    """name -> tree for every recipe whose root has a finite lower bound."""
    trees = {}
    for name, recipe in {**NODE_CASES, **BOUND_CASES}.items():
        tree = recipe(TorchBuilder(), TORCH_KIT)
        if np.isfinite(tree.lower_bound()):
            trees[name] = tree
    return trees


BOUND_TREES = list(_bound_trees())


@pytest.fixture(scope="module")
def bound_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    trees = _bound_trees()
    runs = _host_build(tmp_path_factory.mktemp("bounds"), trees)
    return {name: (tree, runs[name, "on"]) for name, tree in trees.items()}


def _bound_points(tree):
    """Random points in the tree's bounds grown by 20%, and every point of
    a grid whose axis values are the bounds' faces, the centre, 0, points
    between, and huge and infinite values: the solid's inside, its axes,
    faces and deepest point, and far outside."""
    bb = tree.bounds()
    lo, hi = bb.min.astype(np.float32), bb.max.astype(np.float32)
    mid = (lo + hi) / np.float32(2)
    big = np.float32(3.4e38)
    axes = [np.array([lo[i], hi[i], mid[i], 0.0, (lo[i] + mid[i]) / 2, (hi[i] + mid[i]) / 2,
                      np.nextafter(lo[i], np.float32(0)), 1e-7, -1e30, big, -np.inf, np.inf],
                     np.float32) for i in range(tree.NDIM)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, tree.NDIM)
    return np.concatenate([points(tree, seed=5), grid]).astype(np.float32)


def test_every_bounded_class_has_a_case():
    """Each class that states a lower bound is the root of a case below."""
    from gsdf_tpu_torch.core.node import Shader

    classes = {type(t) for t in _bound_trees().values()}
    stated = set()
    todo = [Shader]
    while todo:
        c = todo.pop()
        todo.extend(c.__subclasses__())
        if "lower_bound" in vars(c) and c is not Shader:
            stated.add(c)
    concrete = {c for c in map(type, _codegen_trees().values())} | classes
    for c in list(stated):  # the shared 3D/2D bases count through their classes
        if c.__name__.startswith("_"):
            stated.discard(c)
            stated |= {k for k in c.__subclasses__()}
    assert stated <= classes, stated - classes
    assert classes <= concrete


@pytest.mark.parametrize("name", BOUND_TREES)
def test_lower_bound_holds(name, bound_kernels):
    """The g++-built emitted function never returns less than its root's
    lower_bound() at a non-NaN point: random points, the axes, faces and
    centre, huge and infinite coordinates. A primitive centred at the
    origin reaches its bound at its centre."""
    tree, run = bound_kernels[name]
    lo = tree.lower_bound()
    got = run(_bound_points(tree))
    real = got[~np.isnan(got)]
    assert real.size and real.min() >= lo, (float(real.min()), float(lo))
    if type(tree).__name__ in ("Sphere", "BoxShape", "Cylinder", "Circle", "Rectangle"):
        assert run(np.zeros((1, tree.NDIM), np.float32))[0] == lo


def _geb_half(i):
    """The GEB sculpture's i-th union member: a triple intersection of
    extruded letters (the second translated)."""
    return torch_flagships.build_geb().s.joined[i]


def _slab(b, h=0.8):
    return b.extrude(b.new_hexagon(0.5), h)


#: trees whose root states a point bound (Shader.emit_point_bound): each
#: class that states one, an extrusion so thin (and one flat) that its
#: height's square underflows, transforms that rotate and scale, an
#: intersection with one unbounded child, the GEB sculpture's halves, and
#: the showerhead's hole and a rounded cylinder
POINT_BOUND_CASES = {
    "Cylinder": lambda b: b.new_cylinder(0.8, 25.0),
    "Cylinder-rounded": lambda b: b.new_cylinder(1.2, 2.0, 0.3),
    "Extrusion": lambda b: _slab(b),
    "Extrusion-thin": lambda b: _slab(b, 1e-30),
    "Extrusion-flat": lambda b: _slab(b, 0.0),
    "Transform": lambda b: b.rotate(_slab(b), 0.7, (1, 0.3, 0.2)),
    "Transform-scaled": lambda b: b.transform(_slab(b), np.diag([0.6, 1.7, 1.0, 1.0])),
    "Offset": lambda b: b.offset(_slab(b), -0.05),
    "Translate": lambda b: b.translate(_slab(b), 0.3, -0.2, 0.5),
    "Intersection": lambda b: b.intersection(_slab(b), b.rotate(_slab(b), 1.2, (0, 1, 0))),
    "Intersection-one": lambda b: b.intersection(b.new_sphere(0.6), _slab(b)),
    "geb-first": lambda b: _geb_half(0),
    "geb-second": lambda b: _geb_half(1),
}


@pytest.fixture(scope="module")
def point_bound_kernels(tmp_path_factory):
    """One g++ build of each case's baked function and its point bound:
    {name: (tree, eval(p) -> (n, 2) values and bounds)}."""
    trees = {name: recipe(TorchBuilder()) for name, recipe in POINT_BOUND_CASES.items()}
    return _bound_build(tmp_path_factory.mktemp("point_bounds"), trees)


def _bound_build(d, trees):
    """One g++ build of each tree's baked function and its point bound."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    shim = ["#include <math.h>", "#include <stdint.h>", "#include <string.h>"]
    for j, (name, tree) in enumerate(trees.items()):
        cg = Codegen()
        root = cg.emit(tree)
        lo = cg.point_bound(tree)
        assert lo, name
        (d / f"tree{j}.cuh").write_text(f"// {name}\n{cg.source()}")
        shim.append(
            f'namespace tree{j} {{\n#include "tree{j}.cuh"\n}}\n'
            f'extern "C" void eval{j}(const float* p, float* out, long n) {{\n'
            f"    for (long k = 0; k < n; ++k) {{\n"
            f"        out[2 * k] = tree{j}::{root}(p[3 * k], p[3 * k + 1], p[3 * k + 2]);\n"
            f"        out[2 * k + 1] = tree{j}::{lo}(p[3 * k], p[3 * k + 1], p[3 * k + 2]);\n"
            "    }\n}"
        )
    (d / "shim.cpp").write_text("\n".join(shim) + "\n")
    so = d / "libshim.so"
    subprocess.run(["g++", "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))

    def evaluator(j):
        fn = getattr(lib, f"eval{j}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]

        def run(p):
            p = np.ascontiguousarray(p, np.float32)
            out = np.empty((len(p), 2), np.float32)
            fn(p.ctypes.data, out.ctypes.data, len(p))
            return out

        return run

    return {name: (tree, evaluator(j)) for j, (name, tree) in enumerate(trees.items())}


def test_every_point_bound_class_has_a_case():
    """Each 3D class that states a point bound is the root of a case, and
    only those classes state one (Intersection2D shares Intersection's,
    over 2D children, none of which states one)."""
    from gsdf_tpu_torch.core.node import Shader, Shader3D

    stated, todo = set(), [Shader3D]
    while todo:
        c = todo.pop()
        todo.extend(c.__subclasses__())
        if (c.emit_point_bound is not Shader.emit_point_bound
                or c.radial_bound is not Shader.radial_bound):
            stated.add(c.__name__)
    roots = {type(r(TorchBuilder())).__name__ for r in POINT_BOUND_CASES.values()}
    assert stated == roots == {"Extrusion", "Transform", "Offset", "Translate", "Intersection",
                               "Cylinder"}


@pytest.mark.parametrize("name", list(POINT_BOUND_CASES))
def test_point_bound_holds(name, point_bound_kernels):
    """Wherever the g++-built point bound is no NaN, the baked value is no
    NaN and no less than it: at random points, the bounds' axes, faces and
    centre, huge and infinite coordinates, a NaN coordinate, and heights
    just above and below 2^-63, where a square underflows. The bound is
    reached (outside the slab over the section, the value is |z| - h/2)."""
    tree, run = point_bound_kernels[name]
    p = _bound_points(tree)
    rng = np.random.default_rng(11)
    tiny = np.float32(2.0 ** rng.uniform(-75, -55, 4096)) * rng.choice([-1, 1], 4096)
    near = p[rng.integers(0, len(p), 4096)].copy()
    near[:, 2] = tiny.astype(np.float32)
    with_nan = p[rng.integers(0, len(p), 3 * 1024)].copy()
    with_nan[np.arange(len(with_nan)), np.arange(len(with_nan)) % 3] = np.nan
    p = np.concatenate([p, near, with_nan]).astype(np.float32)
    value, bound = run(p).T
    held = ~np.isnan(bound)
    assert held.mean() > 0.5
    assert not np.isnan(value[held]).any()
    assert (value[held] >= bound[held]).all(), p[held][value[held] < bound[held]][:4]
    assert (value[held] == bound[held]).any()


#: cylinders for the dense test of their point bound: the showerhead's hole,
#: a rounded one, and radii where d_axis - r falls below 2^-63, so that its
#: square underflows (r = 1e-19), and where r itself does (r = 1e-30)
DENSE_CYLINDERS = {"hole": (0.8, 25.0, 0.0), "rounded": (1.2, 2.0, 0.3),
                   "tiny": (1e-19, 1.0, 0.0), "tinier": (1e-30, 2.0, 0.0),
                   "tiny-rounded": (1e-19, 1.0, 2e-20)}


@pytest.fixture(scope="module")
def dense_cylinders(tmp_path_factory):
    from gsdf_tpu_torch.core.primitives3 import Cylinder

    trees = {name: Cylinder(*args) for name, args in DENSE_CYLINDERS.items()}
    return _bound_build(tmp_path_factory.mktemp("dense_cylinders"), trees)


@pytest.mark.parametrize("name", list(DENSE_CYLINDERS))
def test_cylinder_point_bound_dense(name, dense_cylinders):
    """The g++-built Cylinder point bound holds (the value no NaN and no
    less than it wherever it is no NaN) at float32 points dense around
    d_axis = r, 512 ulps of r each way and down to 2^-70 off it, at
    several angles, against heights dense around |z| = h (the half
    height, 64 ulps each way), 0 and beyond; it is NaN exactly where px or
    py is; on the x axis it equals the numpy value of the same radial
    bound (node.radial_at), from which the C is written."""
    tree, run = dense_cylinders[name]
    r, h, _ = (np.float32(v) for v in tree._args())
    radii = np.concatenate([_ulps(r, 512), r + np.float32(2.0 ** np.arange(-70, -50)),
                            r - np.float32(2.0 ** np.arange(-70, -50)), [0, 2 * r, 3]]).astype(np.float32)
    heights = np.concatenate([_ulps(h, 64), -_ulps(h, 64), [0, h / 2, 2 * h, -3 * h]]).astype(np.float32)
    out = []
    for angle in (0.0, np.pi / 4, 1.1, 2.9):
        xy = np.stack([radii * np.float32(np.cos(angle)), radii * np.float32(np.sin(angle))], -1)
        for z in heights:
            out.append(np.concatenate([xy, np.full((len(xy), 1), z)], 1))
    p = np.concatenate(out).astype(np.float32)
    with_nan = p[:: 7].copy()
    with_nan[np.arange(len(with_nan)), np.arange(len(with_nan)) % 3] = np.nan
    value, bound = run(np.concatenate([p, with_nan])).T
    held = ~np.isnan(bound)
    assert not np.isnan(value[held]).any()
    assert (value[held] >= bound[held]).all()
    q = np.concatenate([p, with_nan])
    assert np.array_equal(~held, np.isnan(q[:, 0]) | np.isnan(q[:, 1]))
    on_x = np.stack([radii, np.zeros_like(radii), np.zeros_like(radii)], -1).astype(np.float32)
    d_axis = np.sqrt(radii * radii + np.float32(0))  # as the function computes it
    mirror = np.float32([radial_at(tree.radial_bound(), d) for d in d_axis])
    assert np.array_equal(run(on_x)[:, 1].view(np.uint32), mirror.view(np.uint32))


@pytest.mark.parametrize("t", [1.25, 0.4, 0.0, -0.5, 1e-3, 1e4])
@pytest.mark.parametrize("name", list(DENSE_CYLINDERS))
def test_cylinder_axis_reach(name, t):
    """At and beyond axis_reach(t), 4,096 floats up from it and at a
    spread of larger ones, the radial bound (node.radial_at, equal to the
    emitted one on the x axis) exceeds t, and reach lies within a few ulps
    of r + t + 2^-63 (0 where that is negative)."""
    from gsdf_tpu_torch.core.primitives3 import Cylinder

    cyl, t = Cylinder(*DENSE_CYLINDERS[name]), np.float32(t)
    reach = cyl.axis_reach(t)
    assert reach is not None and reach >= 0
    d = reach
    for _ in range(4096):
        assert radial_at(cyl.radial_bound(), d) > t
        d = np.nextafter(d, np.float32(np.inf))
    for d in np.float32(reach) * np.float32(np.geomspace(1, 1e6, 64)):
        assert radial_at(cyl.radial_bound(), d) > t
    target = max(float(cyl.r) + float(t) + 2.0 ** -63, 0.0)
    assert abs(float(reach) - target) <= 8 * np.spacing(np.float32(max(target, 1e-30)))


#: trees whose short circuits are held to the arithmetic without them: the
#: parts, the recipes with a site, a plate whose minuend (a sphere) is NaN
#: wherever a coordinate is; and unions with point-bounded members: the GEB
#: sculpture and every-type (a union member after an unbounded one), two
#: slabs whose bounds tie on the plane between them, and three slabs (the
#: first runs first, unbounded)
def _exact_trees():
    b = TorchBuilder()
    hole = b.new_cylinder(0.1, 3.0)
    holes = b.union(*[b.translate(hole, 0.5 * np.cos(a), 0.5 * np.sin(a), 0)
                      for a in np.linspace(0, 6, 9)])
    trees = {name: _parts(name)[1] for name in PARTS}
    trees["sphere-holes"] = b.difference(b.new_sphere(1.0), holes)
    for name in ("Difference", "Difference2D", "nine-types", "every-type", "geb"):
        trees[name] = _codegen_trees()[name]
    trees["Difference2D/2d"] = NODE_CASES["Difference2D"](TorchBuilder(), TORCH_KIT)
    slab = b.extrude(b.new_hexagon(0.5), 0.8)
    trees["union-slabs"] = b.union(b.translate(slab, 0, 0, -0.6), b.translate(slab, 0, 0, 0.6))
    bar = b.offset(b.rotate(slab, 0.5, (1, 0, 0)), -0.05)
    trees["union-three"] = b.union(b.translate(slab, 0, 0, -0.6), b.translate(bar, 0.9, 0, 0),
                                   b.translate(slab, 0, 0, 0.7))
    rhole = b.new_cylinder(0.3, 1.0, 0.1)
    spread = np.random.default_rng(3).uniform(-1, 1, (16, 3)) * np.float32([2.0, 2.0, 0.6])
    trees["plate-rounded-holes"] = b.difference(b.new_box(5.0, 5.0, 1.6), b.union(
        *[b.translate(rhole, *v) for v in spread], b.new_cylinder(0.2, 3.0)))
    pin = b.new_cylinder(0.25, 1.0)
    trees["plate-zero"] = b.difference(
        b.difference(b.new_box(3.0, 3.0, 0.8), b.new_sphere(0.5)),
        b.union(*[b.translate(pin, x, y, 0.0) for x, y in ((0.75, 0), (-0.75, 0), (0, 0.75),
                                                          (0, -0.75))]))
    return trees


def _table_loops(tree):
    """The bin-table loops of `tree`'s threshold forms, in emission order
    as the codegen builds them: (the union's shift in the tree's frame,
    the loop's offsets, its member, the reach, the table, the
    Difference's minuend)."""
    out = []
    for node in tree.visit_dfs():
        if type(node).__name__ != "Difference" or not np.isfinite(node.s2.lower_bound()):
            continue
        t_max = -np.float32(node.s1.lower_bound())
        sub, shift = node.s2, np.zeros(3, np.float32)
        while type(sub).__name__ == "Translate":
            shift, sub = shift + sub.p_, sub.s
        if type(sub).__name__ != "OpUnion" or not np.isfinite(t_max):
            continue
        for child, offsets in sub._groups()[0]:
            reach = child.axis_reach(t_max)
            if reach is not None:
                out.append((shift, offsets, child, reach, bin_table(offsets[:, :2], reach),
                            node.s1))
    return out


def _ulps(v, n):
    """float32 v and its n neighbours each way."""
    out, lo, hi = [np.float32(v)], np.float32(v), np.float32(v)
    for _ in range(n):
        lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return np.float32(out)


def _loop_points(tree, seed=9):
    """Points that test each bin-table loop (_table_loops): its grid's
    cell corners, with the float32 steps around some of them (8 ulps each
    way on both axes); points along its grid lines; points just outside
    the grid on each side; around each member's axis, points at distances
    up to 1.05 times the reach and at its radius exactly, on x and y
    (inside the minuend, a < 0, within reach of an axis, a member's value
    exactly 0); each at heights across the minuend's bounds, its faces
    included (a = +0 where a face lies on a float32 plane), and some with
    a NaN, huge or infinite coordinate."""
    rng = np.random.default_rng(seed)
    out = []
    for shift, offsets, member, reach, table, minuend in _table_loops(tree):
        bb = minuend.bounds()
        zs = np.float32(np.concatenate([[bb.min[2], bb.max[2], (bb.min[2] + bb.max[2]) / 2],
                                        rng.uniform(bb.min[2], bb.max[2], 3)]))
        (x0, y0), cell, (nx, ny) = table.origin, table.cell, table.shape
        xs = np.float32(x0 + cell * np.arange(nx + 1))
        ys = np.float32(y0 + cell * np.arange(ny + 1))
        grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
        some = grid[rng.permutation(len(grid))[:48]]
        steps = [np.stack(np.meshgrid(_ulps(x, 8), _ulps(y, 8), indexing="ij"), -1).reshape(-1, 2)
                 for x, y in some]
        lines = [np.stack([np.full(64, x, np.float32), rng.uniform(ys[0], ys[-1], 64)], -1)
                 for x in xs] + [np.stack([rng.uniform(xs[0], xs[-1], 64), np.full(64, y)], -1)
                                 for y in ys]
        outside = []
        for x in (_ulps(xs[0], 4), _ulps(xs[-1], 4)):
            outside.append(np.stack(np.meshgrid(x, rng.uniform(ys[0], ys[-1], 16)), -1))
        for y in (_ulps(ys[0], 4), _ulps(ys[-1], 4)):
            outside.append(np.stack(np.meshgrid(rng.uniform(xs[0], xs[-1], 16), y), -1))
        radii = np.float32(reach) * np.float32([0.0, 0.2, 0.5, 0.8, 0.95, 1.0, 1.05])
        angle = rng.uniform(0, 2 * np.pi, (len(offsets), len(radii), 2))
        around = (offsets[:, None, None, :2] + radii[None, :, None, None]
                  * np.stack([np.cos(angle), np.sin(angle)], -1))
        r = np.float32(getattr(member, "r", reach))
        exact = offsets[:, None, :2] + np.float32([[r, 0], [-r, 0], [0, r], [0, -r]])
        xy = np.concatenate([grid, *steps, *lines, *[o.reshape(-1, 2) for o in outside],
                             around.reshape(-1, 2), exact.reshape(-1, 2)]).astype(np.float32)
        xy = xy + shift[:2]
        p = np.concatenate([np.concatenate([xy, np.full((len(xy), 1), z, np.float32)], 1)
                            for z in zs + shift[2]])
        specials = np.float32([np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, 0.0, -0.0])
        for q in p[rng.integers(0, len(p), 48)]:
            for c in range(3):
                odd = np.repeat(q[None], len(specials), 0)
                odd[:, c] = specials
                out.append(odd)
        out.append(p)
    return np.concatenate(out).astype(np.float32) if out else np.zeros((0, 3), np.float32)


EXACT_TREES = list(_exact_trees())


@pytest.fixture(scope="module")
def exact_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    trees = _exact_trees()
    return trees, _host_build(tmp_path_factory.mktemp("exact"), trees, tuple(SITE_MODES))


def _gap(rec, k, lo):
    """How far each point passes site k's skip test, NaN where it did not
    reach the site: a + lo for a Difference (it skips where its minuend a
    exceeds -lo), lo(p) - a for a union member (it is skipped where the
    running minimum a lies below its point bound lo(p)). float32 rounding
    keeps the sign, so the site skips exactly where the gap is > 0."""
    a, second = rec[..., k, 0], rec[..., k, 1]
    with np.errstate(invalid="ignore"):  # inf - inf where a coordinate is infinite
        return a + np.float32(lo) if lo is not None else second - a


def _site_points(tree, record, seed=7, extra=()):
    """Points that test each short-circuit site: random ones; a dense band
    whose gap (_gap) lies within 1 of 0, the site's threshold; lines along
    each axis from band points and from the 16 points deepest in the
    skipped function (the least b of a Difference's subtrahend, the least
    bound of a union member: where a wrong bound would show), keeping their
    points with the gap near 0 and, bisected, the float32 steps where it
    crosses 0 with 16 ulps on either side (a tie and its neighbours), and
    for a union member also along each axis out to 3e38, where a member's
    bound meets a loop's LARGENUM; band
    points with one coordinate NaN, huge, infinite or a signed zero (a NaN
    minuend, a minuend near infinity, a tie on a plane of symmetry).
    `record` gives each point's two numbers at each site (SITE_MODES);
    the band and the deepest points are also drawn from `extra`."""
    rng = np.random.default_rng(seed)
    nd = tree.NDIM
    base = np.concatenate([points(tree, n=100_000, seed=seed), np.reshape(extra, (-1, nd))])
    out = [base[:4096]]
    ab = record(base)
    reach = np.float32(tree.bounds().diagonal() / 2)
    for k, (_, _, lo) in enumerate(tree_sites(tree)):
        width = 1 if lo is None else np.abs(lo)
        band = base[np.abs(_gap(ab, k, lo)) <= 1]
        band = band[rng.permutation(len(band))[:4096]]
        deep = base[np.argsort(ab[:, k, 1])[:16]]
        assert len(band) > 100, (k, len(band))
        out.append(band)
        starts = [(p, j % nd) for j, p in enumerate(band[:24])]
        starts += [(p, ax) for p in deep for ax in range(nd)]
        lines = [(p, ax, p[ax] + np.linspace(-reach, reach, 4001, dtype=np.float32))
                 for p, ax in starts]
        if lo is None:  # a member's bound may meet the running minimum far out (LARGENUM's)
            far = np.float32(np.geomspace(1e-4, 3e38, 2000))
            lines += [(deep[0], ax, np.concatenate([-far[::-1], far])) for ax in range(nd)]
        for p, ax, values in lines:
            line = np.repeat(p[None], len(values), 0)
            line[:, ax] = values
            gap = _gap(record(line), k, lo)
            out.append(line[np.abs(gap) <= width])
            above = gap > 0
            for i in np.nonzero(above[1:] != above[:-1])[0][:4]:
                lo_z, hi_z = line[i, ax], line[i + 1, ax]  # bisect to adjacent floats
                q = p.copy()
                for _ in range(64):
                    q[ax] = (lo_z + hi_z) / np.float32(2)
                    if q[ax] in (lo_z, hi_z):
                        break
                    if (_gap(record(q[None]), k, lo)[0] > 0) == above[i]:
                        lo_z = q[ax]
                    else:
                        hi_z = q[ax]
                steps = [lo_z]
                for direction in (np.float32(np.inf), np.float32(-np.inf)):
                    w = lo_z
                    for _ in range(16):
                        w = np.nextafter(w, direction)
                        steps.append(w)
                q = np.repeat(p[None], len(steps), 0)
                q[:, ax] = steps
                out.append(q)
        specials = np.float32([np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, 1e38, 0.0, -0.0])
        for p in band[:64]:
            for c in range(nd):
                q = np.repeat(p[None], len(specials), 0)
                q[:, c] = specials
                out.append(q)
    out.append(np.full((1, nd), np.nan, np.float32))
    return np.concatenate(out).astype(np.float32)


#: union sites that no point skips, as the geometry says: nine-types' root
#: union runs its screw (1.0 in radius) first, which is nowhere nearer than
#: the bound of the intersection that a 1.8-radius cylinder cuts, d_axis -
#: 1.8 (the cylinder's point bound makes it a site)
NEVER_SKIPPED = {("nine-types", "opunion_c84d1b08470c/intersection_6ad18d9aa3e5")}

@pytest.mark.parametrize("name", ["showerhead", "sphere-holes", "plate-rounded-holes",
                                  "plate-zero"])
def test_bin_table_lists_every_member_in_reach(name):
    """Each bin-table loop's table, checked by brute force over its
    offsets: every member whose axis comes within the reach of a cell's
    closed rectangle (float64) is in the cell's list, in the loop's order;
    and at float32 points of each cell, its corners and the ulps around
    them included, and just outside the grid, every member the point's
    cell (as the kernel computes it) does not list has a float32 point
    bound above t_max."""
    tree = _exact_trees()[name]
    rng = np.random.default_rng(5)
    loops = _table_loops(tree)
    assert loops
    for _, offsets, member, reach, table, minuend in loops:
        t_max = -np.float32(minuend.lower_bound())
        (x0, y0), cell, (nx, ny) = table.origin, table.cell, table.shape
        xy = offsets[:, :2].astype(np.float64)
        lists = [table.ids[table.starts[c]:table.starts[c + 1]] for c in range(nx * ny)]
        for c, listed in enumerate(lists):
            assert list(listed) == sorted(set(listed))
            ix, iy = c % nx, c // nx
            rx = np.clip(xy[:, 0], x0 + ix * cell, x0 + (ix + 1) * cell)
            ry = np.clip(xy[:, 1], y0 + iy * cell, y0 + (iy + 1) * cell)
            within = np.nonzero(np.hypot(xy[:, 0] - rx, xy[:, 1] - ry) < reach)[0]
            assert set(within) <= set(listed), (c, set(within) - set(listed))
        xs = np.float32(x0 + cell * np.arange(nx + 1))
        ys = np.float32(y0 + cell * np.arange(ny + 1))
        corners = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
        near = [np.stack(np.meshgrid(_ulps(x, 3), _ulps(y, 3), indexing="ij"), -1).reshape(-1, 2)
                for x, y in corners]
        inside = np.stack([rng.uniform(xs[0], xs[-1], 20000), rng.uniform(ys[0], ys[-1], 20000)], -1)
        p = np.concatenate([corners, *near, inside]).astype(np.float32)
        inv = np.float32(1.0 / cell)
        fx, fy = (p[:, 0] - x0) * inv, (p[:, 1] - y0) * inv
        grid = (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
        assert grid.any() and (~grid).any()
        cells = np.where(grid, fy.astype(np.int64) * nx + fx.astype(np.int64), 0)
        listed = np.zeros((nx * ny, len(offsets)), bool)
        for c, members in enumerate(lists):
            listed[c, members] = True
        off = np.float32(offsets[:, :2])
        for i in range(len(offsets)):
            qx, qy = p[:, 0] - off[i, 0], p[:, 1] - off[i, 1]
            bound = radial_at(member.radial_bound(), np.sqrt(qx * qx + qy * qy))
            not_listed = ~grid | ~listed[cells, i]
            assert (bound[not_listed] > t_max).all(), (i, p[not_listed & (bound <= t_max)][:4])


#: sha256 (first 16 hex digits) of the whole baked source of each part
#: with no Difference over a translate-group loop and no Cylinder as a union
#: member, as it was before threshold forms and the Cylinder's point bound,
#: with each polygon's edge loop as it is now (flange, bolt and GEB; the
#: knurled part has none, and its source is as it was)
BAKED_UNCHANGED = {"flange": "3120c23f1af7f6f9", "bolt": "b981e77cd4633dce",
                   "knurled": "be0af495114e2bb7", "geb": "386299dead8d065f"}


@pytest.mark.parametrize("name", list(BAKED_UNCHANGED))
def test_baked_source_unchanged(name, codegen_trees):
    """These parts' baked sources are byte for byte as before (their
    parametric ones, as every tree's, are held by SOURCE_HASHES)."""
    src = tree_source(codegen_trees[name])
    assert "_below(" not in src and "GSDF_LOOP" not in src
    assert _digest(src) == BAKED_UNCHANGED[name]


#: trees whose minuend lets points outside the grid or in an empty cell
#: reach the loop, so that some walk no member (the showerhead's rim beyond
#: the holes, the plates' corners; the sphere's holes reach all of it)
WALK_NONE = {"showerhead", "plate-rounded-holes", "plate-zero"}

#: trees whose points (_loop_points) give a Difference over a bin-table
#: loop a signed-zero minuend: a plate's face (+0), a sphere's surface cut
#: from a box (-0, fmaxf(a', -(+0)))
SIGNED_ZERO_MINUENDS = {"showerhead": False, "plate-zero": True}


def _check_loop_walks(name, tree, sites, walks, ab, p):
    """Where a point enters a bin-table loop of the tree's threshold forms
    it walks all n members (px + py NaN, or a NaN or too great a
    threshold), or at most its table's longest list; the points walk some
    and all of them, and none on the trees of WALK_NONE;
    the Difference over the loop sees the signed-zero minuend its tree is
    listed with."""
    tables = _table_loops(tree)
    assert len(tree_loops(tree)) == len(tables)
    for k, ((loop, _, n), (_, _, _, _, table, minuend)) in enumerate(zip(tree_loops(tree), tables)):
        w = walks[:, k]
        entered = ~np.isnan(w)
        longest = np.diff(table.starts).max()
        assert (np.isin(w[entered], np.arange(longest + 1)) | (w[entered] == n)).all(), loop
        assert (w[entered & np.isnan(p[:, 0] + p[:, 1])] == n).all(), loop
        assert ((w > 0) & (w <= longest)).any() and (w == n).any(), loop
        assert (w == 0).any() == (name in WALK_NONE), loop
    if name in SIGNED_ZERO_MINUENDS:
        k = next(i for i, (_, sub, lo) in enumerate(sites) if sub.startswith("opunion")
                 and lo is not None)
        a = ab[:, k, 0]
        assert ((a == 0) & (np.signbit(a) == SIGNED_ZERO_MINUENDS[name])).any(), name


@pytest.mark.parametrize("name", EXACT_TREES)
def test_short_circuits_exact(name, exact_kernels):
    """The baked source with its short circuits equals, bit for bit, the
    same source with every site off (the arithmetic of a source without
    them) at random points, in a dense band around each site's threshold,
    at the float32 steps across it, and at band points with a NaN, huge,
    infinite or zero coordinate, and equals the plain torch version
    wherever a finite result is finite there; the skips engage on each
    site, a Difference's and a union's alike."""
    trees, runs = exact_kernels
    tree = trees[name]
    sites = tree_sites(tree)
    if not sites:
        assert "GSDF_SITE" not in tree_source(tree)
        p = points(tree, seed=7)
        assert np.array_equal(runs[name, "on"](p).view(np.uint32),
                              runs[name, "off"](p).view(np.uint32))
        return
    record = runs[name, "record"]
    near_loops = _loop_points(tree) if tree.NDIM == 3 else ()
    p = np.concatenate([_site_points(tree, record, extra=near_loops),
                        np.reshape(near_loops, (-1, tree.NDIM))]).astype(np.float32)
    on, off = runs[name, "on"](p), runs[name, "off"](p)
    assert np.array_equal(on.view(np.uint32), off.view(np.uint32))
    ab = record(p)
    _check_loop_walks(name, tree, sites, runs[name, "walk"](p), ab, p)
    for k, (_, _, lo) in enumerate(sites):
        a, b = ab[:, k, 0], ab[:, k, 1]
        reached = ~np.isnan(a)
        skipped = reached & (_gap(ab, k, lo) > 0) & ~np.isnan(p).any(axis=1)
        if (name, sites[k][0]) in NEVER_SKIPPED:
            assert reached.any() and not skipped.any(), sites[k]
        else:
            assert skipped.any() and (reached & ~skipped).any()
        if lo is None:  # a union member's point bound b: a tie's ulps, a near skip
            gap = _gap(ab, k, lo)
            assert (reached & (np.abs(gap) <= 8 * np.spacing(b))).any(), sites[k]
            if (name, sites[k][0]) in NEVER_SKIPPED:
                continue
            assert (skipped & (gap <= np.float32(0.1) * np.abs(b))).any(), sites[k]
            if name == "union-slabs":  # on the plane between the slabs
                assert (reached & (a == b) & ~skipped).any()
            continue
        # the steps across the threshold reach it within a few ulps
        assert (np.abs(a + lo) <= 8 * np.spacing(-lo)).any(), sites[k]
        assert (skipped & (a <= -lo * np.float32(1.1))).any()
        if name == "showerhead" and sites[k][1].startswith("opunion"):  # a hole's axis above the plate
            assert (skipped & (a <= -lo * np.float32(1.1)) & (b <= lo * np.float32(0.9))).any()
    if name == "sphere-holes":
        assert np.isnan(ab[:, 0, 0]).any()
    near = (np.abs(p) < 1e6).all(axis=1)  # huge ones overflow differently in torch
    ref = torch_distance(tree, p[near])
    np.testing.assert_allclose(on[near], ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(on[near] < 0, ref < 0)


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
