"""The port's host I/O (CPU): the native STL encoder, decoder and welder
against their numpy plain versions, the STL round trip and validation,
and OBJ/PLY bytes against the JAX package's (mirrors tests/test_native.py
and tests/test_render_golden.py:23-70)."""
import io

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
