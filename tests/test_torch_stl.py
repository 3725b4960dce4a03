"""The port's host I/O (CPU): the native STL encoder, decoder and welder
against their numpy plain versions, the STL round trip and validation,
and OBJ/PLY bytes against the JAX package's (mirrors tests/test_native.py
and tests/test_render_golden.py:23-70). Also: the port's own copy of the
C++ source equals the JAX package's byte for byte, and nothing in the port
imports jax or the JAX package or builds a path into it."""
import ast
import io
import os
import re

import numpy as np
import pytest

from gsdf_tpu.render import mesh_export as jax_mesh_export
from gsdf_tpu.render.stl import write_binary_stl as jax_write_binary_stl
from gsdf_tpu_torch import Builder
from gsdf_tpu_torch import native
from gsdf_tpu_torch.render import mesh_export
from gsdf_tpu_torch.render.flat import FlatRenderer
from gsdf_tpu_torch.render.stl import (
    _STL_DTYPE,
    read_binary_stl,
    validate_stl_triangles,
    write_binary_stl,
    write_stl_file,
)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_copy_matches_reference():
    """The port compiles its own native.cpp; the copy must not drift from
    the JAX package's file while that package stays frozen."""
    assert os.path.dirname(native.NATIVE_SRC) == os.path.join(REPO, "gsdf_tpu_torch", "native")
    with open(native.NATIVE_SRC, "rb") as f, \
            open(os.path.join(REPO, "gsdf_tpu", "native", "native.cpp"), "rb") as g:
        assert f.read() == g.read()


def _port_sources():
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "bounds.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gsdf_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def test_port_uses_nothing_of_the_jax_package():
    """No module of the port, nor chip_smoke.py or bounds.py, imports jax or gsdf_tpu,
    and none holds a string that names a path into gsdf_tpu/ (a citation
    of the reference by file and line, "gsdf_tpu/x.py:12", is none). The
    text modules are among them, and the font they load is the port's own
    file."""
    sources = _port_sources()
    assert len(sources) > 30
    textsdf = os.path.join(REPO, "gsdf_tpu_torch", "forge", "textsdf")
    assert {os.path.join(textsdf, f) for f in ("__init__.py", "font.py")} <= set(sources)
    from gsdf_tpu_torch.forge.textsdf import font
    assert os.path.commonpath([font.EMBEDDED_FONT_PATH, textsdf]) == textsdf
    citation = re.compile(r"^gsdf_tpu/[\w/.]+:\d+(-\d+)?$")
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "gsdf_tpu"):
                    bad.append(f"{path}:{node.lineno} imports {name}")
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                v = node.value
                if (v == "gsdf_tpu" or v.startswith(("gsdf_tpu/", "gsdf_tpu\\"))) \
                        and not citation.match(v):
                    bad.append(f"{path}:{node.lineno} names the path {v!r}")
    assert not bad, bad


def test_port_version_is_the_jax_packages():
    """The port exports __version__, the JAX package's version."""
    import gsdf_tpu
    import gsdf_tpu_torch

    assert "__version__" in gsdf_tpu_torch.__all__
    assert gsdf_tpu_torch.__version__ == gsdf_tpu.__version__ == "0.1.0"


def _sphere_soup(r=0.6, res=0.05):
    return FlatRenderer(Builder().new_sphere(r), res, "cpu").render()


def test_stl_encode_matches_plain():
    rng = np.random.default_rng(3)
    tris = rng.normal(size=(500, 3, 3)).astype(np.float32)
    tris[7] = tris[7, 0]  # a degenerate triangle: zero normal
    assert native.stl_encode(tris) == native.stl_encode_plain(tris)
    rec = np.frombuffer(native.stl_encode(tris), dtype=_STL_DTYPE)
    np.testing.assert_array_equal(rec["normal"][7], 0.0)


def test_stl_decode_matches_plain():
    tris = _sphere_soup()
    data = native.stl_encode(tris)
    np.testing.assert_array_equal(native.stl_decode(data, len(tris)), tris)
    np.testing.assert_array_equal(native.stl_decode_plain(data, len(tris)), tris)


@pytest.mark.parametrize("tol", [0.0, 1e-6, 1e-2])
def test_weld_matches_plain(tol):
    tris = _sphere_soup()
    verts, idx = native.weld(tris, tol)
    pverts, pidx = native.weld_plain(tris, tol)
    np.testing.assert_array_equal(verts, pverts)
    np.testing.assert_array_equal(idx, pidx)
    assert idx.shape == (len(tris), 3) and len(verts) < 3 * len(tris)
    if tol == 0.0:
        np.testing.assert_array_equal(verts[idx], tris)  # exact duplicates only


def test_weld_of_empty_soup():
    verts, idx = native.weld(np.empty((0, 3, 3), np.float32))
    assert verts.shape == (0, 3) and idx.shape == (0, 3)
    with pytest.raises(ValueError):
        native.weld(np.zeros((4, 3), np.float32))


def test_stl_roundtrip():
    tris = FlatRenderer(Builder().new_box(1.0, 0.75, 0.5, 0.05), 0.05, "cpu").render()
    buf = io.BytesIO()
    assert write_binary_stl(buf, tris) == 84 + 50 * len(tris)
    buf.seek(0)
    np.testing.assert_array_equal(read_binary_stl(buf), tris)
    with pytest.raises(ValueError, match="empty"):
        write_binary_stl(io.BytesIO(), np.empty((0, 3, 3), np.float32))


def test_stl_file_roundtrip(tmp_path):
    tris = _sphere_soup()
    path = str(tmp_path / "sphere.stl")
    write_stl_file(path, tris)
    np.testing.assert_array_equal(read_binary_stl(path), tris)


def test_stl_validation():
    tris = _sphere_soup(0.5)
    rec = np.frombuffer(native.stl_encode(tris), dtype=_STL_DTYPE)
    stats = validate_stl_triangles(rec)
    assert stats["nonfinite"] == 0 and stats["normal_mismatches"] == 0
    buf = io.BytesIO()
    write_binary_stl(buf, tris)
    buf.seek(0)
    assert len(read_binary_stl(buf, validate=True)) == len(tris)
    with pytest.raises(ValueError, match="0 triangles"):
        read_binary_stl(io.BytesIO(bytes(84)))


def test_stl_bytes_match_jax():
    tris = _sphere_soup()
    a, b = io.BytesIO(), io.BytesIO()
    write_binary_stl(a, tris)
    jax_write_binary_stl(b, tris)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("fmt", ["obj", "ply"])
def test_mesh_export_bytes_match_jax(fmt, tmp_path):
    """Both packages' writers on one mesh: the soup, and it welded."""
    tris = FlatRenderer(Builder().new_box(1, 1, 1, 0.1), 0.1, "cpu").render()
    verts, idx = native.weld(tris)
    port, ref = tmp_path / f"port.{fmt}", tmp_path / f"ref.{fmt}"
    getattr(mesh_export, f"write_{fmt}_file")(str(port), tris)
    getattr(jax_mesh_export, f"write_{fmt}_file")(str(ref), tris)
    assert port.read_bytes() == ref.read_bytes()
    getattr(mesh_export, f"write_{fmt}_indexed_file")(str(port), verts, idx)
    getattr(jax_mesh_export, f"write_{fmt}_indexed_file")(str(ref), verts, idx)
    assert port.read_bytes() == ref.read_bytes()
    if fmt == "obj":
        assert port.read_text().count("f ") == len(tris)
