"""Parity of the PyTorch port's node tree with the JAX package (CPU).

The same numpy inputs (np.random.default_rng) go through the JAX node's
`distance` and the port's. JAX runs op by op (`jax.disable_jit`): jitted
XLA-CPU code contracts multiply-adds into FMAs, which moves about half of
all values by an ulp, while each op alone rounds as IEEE float32, as the
port does. What still differs is atan2's last ulp (XLA's vs the C
library's) on the screw nodes, at the flange's 25 mm scale: hence
rtol=1e-6, atol=1e-5.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.forge import threads as jax_threads
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch import flagships as torch_flagships
from gsdf_tpu_torch.codegen.cuda import lit, tree_source
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.forge import threads as torch_threads

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
}


def both(recipe):
    return (
        recipe(JaxBuilder(), jax_threads),
        recipe(TorchBuilder(), torch_threads),
    )


@pytest.mark.parametrize("case", list(NODE_CASES))
def test_node_distance_matches_jax(case):
    jnode, tnode = both(NODE_CASES[case])
    assert type(tnode).__qualname__ == type(jnode).__qualname__
    assert tnode.tree_hash() == jnode.tree_hash()
    p = points(jnode)
    np.testing.assert_allclose(
        torch_distance(tnode, p), jax_distance(jnode, p), rtol=RTOL, atol=ATOL
    )


PARTS = ["flange", "showerhead"]


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


def test_from_reference_tree_rejects_unported_node():
    jb = JaxBuilder()
    with pytest.raises(NotImplementedError, match="Sphere"):
        from_reference_tree(jb.union(jb.new_sphere(1.0), jb.new_cylinder(1.0, 1.0)))


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
SHIM = """
#include "gsdf_tree.cuh"
extern "C" void gsdf_eval_points(const float* p, float* out, long n) {
    for (long i = 0; i < n; ++i) out[i] = gsdf_tree(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
"""


def _nine_type_tree(b, t):
    """All nine node types of the slice in one tree."""
    body = b.smooth_union(0.2, _opunion(b, t), b.scale(_difference(b, t), 0.8))
    return b.union(b.intersection(body, b.new_cylinder(1.8, 1.8, 0.1)), _screw(b, t))


def _host_eval(tree, p, tmp_path):
    (tmp_path / "gsdf_tree.cuh").write_text(tree_source(tree))
    (tmp_path / "shim.cpp").write_text(SHIM)
    so = tmp_path / "libshim.so"
    subprocess.run(
        ["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", str(tmp_path), "-o", str(so), str(tmp_path / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    lib.gsdf_eval_points.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.gsdf_eval_points.restype = None
    p = np.ascontiguousarray(p, np.float32)
    out = np.empty(len(p), np.float32)
    lib.gsdf_eval_points(p.ctypes.data, out.ctypes.data, len(p))
    return out


@pytest.mark.parametrize("name", PARTS + ["nine-types"])
def test_codegen_matches_plain_torch(name, tmp_path):
    """Emitter bugs show here before any chip time: g++ builds the very
    source nvcc builds (no FMA contraction on either). The C library's
    atan2f may differ from torch's by an ulp, so distances compare at
    atol=1e-5; their signs, which decide the MC cases, must agree."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    if name == "nine-types":
        tree = _nine_type_tree(TorchBuilder(), torch_threads)
    else:
        tree = _parts(name)[1]
    kinds = {type(n).__name__ for n in tree.visit_bfs()}
    p = points(tree, seed=3)
    got = _host_eval(tree, p, tmp_path)
    ref = torch_distance(tree, p)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got < 0, ref < 0)
    if name == "nine-types":
        assert len(kinds) == 9, kinds


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
