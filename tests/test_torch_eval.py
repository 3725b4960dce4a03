"""The port's point evaluators (gsdf_tpu_torch.eval) against the JAX
package's on the CPU: SDF3 / SDF2, normals, the two memo caches, the
Batcher, the special evaluators and the colour conversions.

The same numpy inputs (np.random.default_rng) go through both packages,
and the port's tree is `convert.from_reference_tree` of the JAX tree, so
both evaluate the very same part. JAX runs op by op (`jax.disable_jit`),
as in the other test_torch_* files: jitted XLA-CPU code contracts
multiply-adds. On the CPU the port's evaluators run the plain torch tree
(the point kernel KP's plain version); tests/test_torch_cuda.py holds KP
against it on a card.

Tolerances: distances within 1e-6 + 1e-6 * |d|. Bit-identical (asserted)
on the flange, the showerhead, the bolt and every 2D recipe but two; the
knurled cylinder's Twist (sin, cos), Ellipse2D and QuadraticBezier2D
(acos, cube root) differ from XLA's transcendentals by one ulp, which at
the knurled part's 25 mm scale is 1.9e-6.
"""
import subprocess
import sys

import chip_smoke
import jax
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import eval as jax_eval
from gsdf_tpu.eval import special as jax_special
from gsdf_tpu.pipeline import colors as jax_colors
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch import eval as torch_eval
from gsdf_tpu_torch import kernels
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.eval import point_kernels, special
from gsdf_tpu_torch.pipeline import colors
from gsdf_tpu_torch.render.flat import FlatRenderer
from test_torch_nodes import (
    JAX_KIT, NODE_CASES, PARTS, RECIPES_2D, REPO, TORCH_KIT, _parts, points,
)

RTOL, ATOL = 1e-6, 1e-6
#: parts and 2D recipes whose distances differ from the JAX package's by
#: an ulp of a transcendental; every other one is bit-identical
ULP_CASES = {"knurled", "Ellipse2D", "QuadraticBezier2D"}
CPU = jax.devices("cpu")[0]


def _jax_evaluate(sdf, p):
    with jax.disable_jit():
        return sdf.evaluate(p)


def _check(name, got, ref):
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if name not in ULP_CASES:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", PARTS)
def test_sdf3_evaluate_matches_jax(name):
    jtree = _parts(name)[0]
    p = points(jtree, n=4096, seed=11)
    ref_sdf = jax_eval.new_cpu_sdf3(jtree)
    sdf = torch_eval.new_cpu_sdf3(from_reference_tree(jtree))
    _check(name, sdf.evaluate(p), _jax_evaluate(ref_sdf, p))
    assert sdf.evaluations() == ref_sdf.evaluations() == 4096
    np.testing.assert_array_equal(sdf.bounds().min, ref_sdf.bounds().min)
    np.testing.assert_array_equal(sdf.bounds().max, ref_sdf.bounds().max)


def test_2d_recipes_cover_every_2d_node_type():
    """The 2D recipes here, and the ones chip_smoke.py holds KP and K2-2D
    to on the card, reach every 2D node type; chip_smoke's hash the same
    through both packages' Builders."""
    from gsdf_tpu_torch.convert import NODE_TYPES

    types_2d = {k for k, c in NODE_TYPES.items() if c.NDIM == 2}
    here = [NODE_CASES[name](TorchBuilder(), TORCH_KIT) for name in RECIPES_2D]
    smoke = chip_smoke.recipes_2d(TorchBuilder(), TORCH_KIT.with_bounds, TORCH_KIT.Box)
    ref = chip_smoke.recipes_2d(JaxBuilder(), JAX_KIT.with_bounds, JAX_KIT.Box)
    for trees in (here, list(smoke.values())):
        assert all(t.NDIM == 2 for t in trees)
        assert types_2d <= {type(n).__qualname__ for t in trees for n in t.visit_bfs()}
    assert types_2d <= set(smoke) and len(types_2d) == 28
    assert {k: t.tree_hash() for k, t in smoke.items()} == {k: t.tree_hash() for k, t in ref.items()}


@pytest.mark.parametrize("name", RECIPES_2D)
def test_sdf2_evaluate_matches_jax(name):
    jtree = NODE_CASES[name](JaxBuilder(), JAX_KIT)
    p = points(jtree, n=2048, seed=12)
    sdf = torch_eval.new_sdf2(from_reference_tree(jtree), "cpu")
    _check(name, sdf.evaluate(p), _jax_evaluate(jax_eval.new_sdf2(jtree, CPU), p))
    assert sdf.evaluations() == 2048


def test_evaluate_device_matches_evaluate():
    """evaluate_device takes (..., 3) tensors on the evaluator's device and
    counts as the JAX package counts (the product of the leading shape)."""
    sdf = torch_eval.new_cpu_sdf3(_parts("bolt")[1])
    p = points(sdf.s, n=600, seed=13)
    d = sdf.evaluate_device(torch.from_numpy(p).reshape(20, 30, 3))
    assert d.shape == (20, 30) and d.dtype == torch.float32
    np.testing.assert_array_equal(d.reshape(-1).numpy(), sdf.evaluate(p))
    assert sdf.evaluations() == 1200
    strided = torch.from_numpy(np.concatenate([p, p], axis=1))[:, :3]  # not contiguous
    np.testing.assert_array_equal(sdf.evaluate_device(strided).numpy(), d.reshape(-1).numpy())


def test_evaluator_input_errors():
    """Shape and type errors as the JAX evaluators raise them
    (gsdf_tpu/eval/evaluator.py:84-89, :112, :123); an empty batch is an
    empty result."""
    b, jb = TorchBuilder(), JaxBuilder()
    for mod, bld, cpu in ((torch_eval, b, "cpu"), (jax_eval, jb, CPU)):
        sdf3 = mod.new_cpu_sdf3(bld.new_sphere(1.0))
        sdf2 = mod.new_sdf2(bld.new_circle(1.0), cpu)
        for sdf, bad in ((sdf3, np.zeros((4, 2), np.float32)), (sdf2, np.zeros((4, 3), np.float32)),
                         (sdf3, np.zeros(3, np.float32)), (sdf3, np.zeros((2, 2, 3), np.float32))):
            with pytest.raises(ValueError, match="positions"):
                sdf.evaluate(bad)
        empty = sdf3.evaluate(np.zeros((0, 3), np.float32))
        assert empty.shape == (0,) and empty.dtype == np.float32 and sdf3.evaluations() == 0
        # other dtypes are converted, as np.ascontiguousarray(pos, float32) does
        np.testing.assert_array_equal(sdf3.evaluate(np.array([[2, 0, 0]], np.int64)), [1.0])
        with pytest.raises(TypeError, match="Shader3D"):
            mod.SDF3(bld.new_circle(1.0), cpu)
        with pytest.raises(TypeError, match="Shader2D"):
            mod.SDF2(bld.new_sphere(1.0), cpu)


def test_point_kernel_wrapper_checks_its_tensor():
    """KP's wrapper takes (N, NDIM) float32, contiguous, on the device it
    is given, and raises on anything else; N = 0 gives an empty tensor."""
    tree = TorchBuilder().new_sphere(1.0)
    good = torch.zeros((5, 3), dtype=torch.float32)
    assert point_kernels.evaluate_points(tree, good, "cpu").shape == (5,)
    assert point_kernels.evaluate_points(tree, good[:0], "cpu").shape == (0,)
    for bad in (good.double(), torch.zeros((5, 2)), torch.zeros((5, 6))[:, ::2], torch.zeros(3),
                torch.zeros((5, 3), dtype=torch.int32)):
        with pytest.raises(ValueError):
            point_kernels.evaluate_points(tree, bad, "cpu")
    sdf = torch_eval.new_cpu_sdf3(tree)
    with pytest.raises(ValueError):
        sdf.evaluate_device(good.double())
    with pytest.raises(ValueError, match="positions"):
        sdf.evaluate_device(torch.zeros((5, 2)))


def test_entry_points_default_to_the_card():
    """With no `device` argument every entry point of the slice, and
    FlatRenderer, runs on the card; with no card it raises and does not
    carry on on the CPU."""
    from gsdf_tpu_torch import flagships, pipeline, render

    assert kernels.default_device() == torch.device("cuda")
    assert kernels.entry_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.entry_device("meta")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    b = TorchBuilder()
    ball, disc = b.new_sphere(1.0), b.new_circle(1.0)
    calls = [
        lambda: kernels.entry_device(None),
        lambda: torch_eval.new_sdf3(ball),
        lambda: torch_eval.new_sdf2(disc),
        lambda: torch_eval.SDF3(ball),
        lambda: torch_eval.Batcher(),
        lambda: torch_eval.polygon_gpu([(0, 0), (1, 0), (0, 1)]),
        lambda: special.throughput_grid(ball, (4, 4, 4)),
        lambda: special.run_benchmarks(16),
        lambda: FlatRenderer(ball, 0.1),
        lambda: render.render_flat(ball, 0.1),
        lambda: render.render_distance_field(disc, 8, 8),
        lambda: render.render_image_2d(disc, 8, 8),
        lambda: pipeline.render_png_file_2d("unused.png", disc, 8, 8),
        lambda: pipeline.render_shader3d(ball, pipeline.RenderConfig(resolution=0.1)),
        lambda: flagships.showerhead_scene(b, thread_png="unused.png"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert torch_eval.new_cpu_sdf3(ball).device == torch.device("cpu")


# --- the analogs of tests/test_aux.py ------------------------------------
def test_batcher_ops():
    b = torch_eval.Batcher(torch_eval.BatcherConfig(device="cpu"))
    ref = jax_eval.Batcher()
    rng = np.random.default_rng(3)
    a, c = rng.normal(size=(2, 1000)).astype(np.float32)
    for op in ("union", "diff", "intersect"):
        np.testing.assert_array_equal(getattr(b, op)(None, a, c), getattr(ref, op)(None, a, c))
    np.testing.assert_array_equal(b.union(None, a, c), np.minimum(a, c))
    np.testing.assert_array_equal(b.diff(None, a, c), np.maximum(a, -c))
    np.testing.assert_array_equal(b.intersect(None, a, c), np.maximum(a, c))
    dst = np.empty(1000, np.float32)
    out = b.execute_raw_binary_operation(lambda x, y: x * 2 + y, dst, a, c)
    np.testing.assert_array_equal(out, a * 2 + c)
    assert out is dst
    # a fresh callable per call costs nothing to keep: there is no cache
    for k in range(8):
        np.testing.assert_array_equal(
            b.execute_raw_binary_operation(lambda x, y, k=k: x - y * k, None, a, c),
            a - c * np.float32(k))


def test_special_evaluators_match_tree():
    bld = TorchBuilder()
    pts = np.random.default_rng(0).uniform(-1, 1, (128, 2)).astype(np.float32)
    verts = [(-0.5, -0.4), (0.5, -0.5), (0.4, 0.5), (-0.3, 0.35)]
    segs = [[(0, 0), (1, 0)], [(1, 0), (1, 1)]]
    disp = [(0.5, 0), (-0.5, 0)]
    cases = (
        (special.polygon_gpu(verts, "cpu"), bld.new_polygon(verts),
         jax_special.polygon_gpu(verts, CPU)),
        (special.lines2d_gpu(segs, 0.1, "cpu"), bld.new_lines2d(segs, 0.1),
         jax_special.lines2d_gpu(segs, 0.1, CPU)),
        (special.displace_multi2d(bld.new_circle(0.2), disp, "cpu"),
         bld.translate_multi2d(bld.new_circle(0.2), disp),
         jax_special.displace_multi2d(JaxBuilder().new_circle(0.2), disp, CPU)),
    )
    for sdf, tree, ref in cases:
        assert isinstance(sdf, torch_eval.SDF2) and sdf.s.tree_hash() == ref.s.tree_hash()
        got = sdf.evaluate(pts)
        np.testing.assert_array_equal(got, torch_eval.new_sdf2(tree, "cpu").evaluate(pts))
        np.testing.assert_allclose(got, _jax_evaluate(ref, pts), rtol=0, atol=1e-6)
    d = cases[2][0].evaluate(np.array([[0.5, 0], [-0.5, 0], [0, 0]], np.float32))
    np.testing.assert_allclose(d[:2], -0.2, atol=1e-6)
    assert d[2] > 0


def test_throughput_entry_points(monkeypatch):
    """throughput and throughput_grid at a toy size on the CPU (their
    numbers mean nothing here), and run_benchmarks' battery: the
    reference's three sizes, a deep 3D tree and the 256^3 grid."""
    sdf = torch_eval.new_cpu_sdf3(TorchBuilder().new_sphere(1.0))
    eps, ms = special.throughput(sdf, n_points=512, repeats=2)
    assert eps > 0 and ms > 0 and sdf.evaluations() == 3 * 512
    eps, ms = special.throughput(special.polygon_gpu([(0, 0), (1, 0), (0, 1)], "cpu"), 64, 1)
    assert eps > 0
    eps, ms = special.throughput_grid(sdf.s, (6, 7, 8), repeats=2, device="cpu")
    assert eps > 0 and ms > 0

    grids = []
    monkeypatch.setattr(special, "throughput_grid",
                        lambda tree, shape, **kw: grids.append((shape, kw)) or (1.0, 1.0))
    lines = []
    out = special.run_benchmarks(n_points=256, device="cpu", log=lines.append)
    assert list(out) == ["polygon_gpu(64v)", "lines2d_gpu(128s)", "displace_multi2d(128d)",
                         "deep_tree_3d", "deep_tree_3d_grid_on_device"]
    assert grids == [((256, 256, 256), {"device": "cpu"})] and len(lines) == 5
    assert all(v > 0 for v in out.values())


def test_normals_point_outward():
    sdf = torch_eval.new_cpu_sdf3(TorchBuilder().new_sphere(1.0))
    pts = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
    n = torch_eval.normals_central_diff(sdf, pts, 1e-3)
    assert sdf.evaluations() == 18
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(n, pts / np.linalg.norm(pts, axis=1, keepdims=True), atol=1e-3)
    with pytest.raises(ValueError, match="step"):
        torch_eval.normals_central_diff(sdf, pts, 0.0)


def test_normals_match_jax_and_the_six_call_form():
    """One upload and six device evaluations give bit for bit what six
    host-to-host evaluate calls give, and what the JAX package gives on
    the bolt (whose distances are bit-identical)."""
    jtree = _parts("bolt")[0]
    sdf = torch_eval.new_cpu_sdf3(from_reference_tree(jtree))
    p = points(jtree, n=512, seed=14)
    got = torch_eval.normals_central_diff(sdf, p, 0.01)
    assert got.shape == (512, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, torch_eval.normals_central_diff(chip_smoke.HostOnly(sdf), p, 0.01))
    with jax.disable_jit():
        ref = jax_eval.normals_central_diff(jax_eval.new_cpu_sdf3(jtree), p, 0.01)
    np.testing.assert_array_equal(got, ref)


def test_block_cached_sdf3():
    sdf = torch_eval.new_cpu_sdf3(TorchBuilder().new_sphere(1.0))
    ref = jax_eval.BlockCachedSDF3(jax_eval.new_cpu_sdf3(JaxBuilder().new_sphere(1.0)), 0.1, 0.1, 0.1)
    cached = torch_eval.BlockCachedSDF3(sdf, 0.1, 0.1, 0.1)
    pts = np.random.default_rng(1).uniform(-1, 1, (256, 3)).astype(np.float32)
    d1 = cached.evaluate(pts)
    d2 = cached.evaluate(pts)  # all hits, each from a point of the same voxel
    np.testing.assert_allclose(d1, d2, atol=0.1 * np.sqrt(3))
    assert cached.cache_hits() >= 256 and cached.evaluations() == 512
    with jax.disable_jit():
        np.testing.assert_allclose(d1, ref.evaluate(pts), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d2, ref.evaluate(pts), rtol=0, atol=1e-6)
    assert cached.cache_hits() == ref.cache_hits()
    # outside the 21-bit key space a point bypasses the cache
    far = np.array([[-200000.0, 0.0, 0.0]], np.float32)
    hits0 = cached.cache_hits()
    df1, df2 = cached.evaluate(far), cached.evaluate(far)
    np.testing.assert_allclose(df1, df2)
    np.testing.assert_allclose(df1[0], 200000.0 - 1.0, rtol=1e-5)
    assert cached.cache_hits() == hits0
    with pytest.raises(ValueError):
        torch_eval.BlockCachedSDF3(sdf, 0.1, 0.0, 0.1)
    with pytest.raises(ValueError, match="empty"):
        cached.evaluate(np.zeros((0, 3), np.float32))


def test_cached_exact_sdf3():
    sdf = torch_eval.new_cpu_sdf3(TorchBuilder().new_sphere(1.0))
    cached = torch_eval.CachedExactSDF3(sdf)
    pts = np.random.default_rng(2).uniform(-1, 1, (256, 3)).astype(np.float32)
    d1 = cached.evaluate(pts)
    assert cached.cache_hits() == 0
    np.testing.assert_array_equal(d1, cached.evaluate(pts))  # bit-identical positions hit
    assert cached.cache_hits() == 256 and cached.evaluations() == 512
    assert sdf.evaluations() == 256
    nudged = pts.copy()
    nudged[:, 0] = np.nextafter(nudged[:, 0], np.float32(np.inf))
    cached.evaluate(nudged)  # a 1-ulp nudge misses
    assert cached.cache_hits() == 256
    dup = np.repeat(pts[:4], 3, axis=0)  # already cached: all 12 hit
    np.testing.assert_array_equal(cached.evaluate(dup), np.repeat(d1[:4], 3))
    assert cached.cache_hits() == 256 + 12
    fresh = np.random.default_rng(3).uniform(2, 3, (4, 3)).astype(np.float32)
    dupf = np.repeat(fresh, 3, axis=0)  # 12 rows of 4 new positions: no hit
    df = cached.evaluate(dupf)
    np.testing.assert_array_equal(df, np.repeat(df[::3], 3))
    assert cached.cache_hits() == 256 + 12
    np.testing.assert_array_equal(cached.evaluate(dupf), df)
    assert cached.cache_hits() == 256 + 24
    np.testing.assert_array_equal(cached.bounds().min, sdf.bounds().min)
    np.testing.assert_array_equal(cached.bounds().max, sdf.bounds().max)


def test_colors():
    """The colour conversions are host numpy in both packages: equal
    images, NaN red in the IQ palette."""
    d = np.linspace(-1, 1, 64).reshape(8, 8).astype(np.float32)
    d[2, 3] = np.nan
    for name, args in (("color_conversion_inigo_quilez", (0.5,)),
                       ("color_conversion_linear_gradient", (0, 240, 0.5))):
        with np.errstate(invalid="ignore"):
            img = getattr(colors, name)(*args)(d)
            ref = getattr(jax_colors, name)(*args)(d)
        assert img.shape == (8, 8, 4) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, ref)
    img = colors.color_conversion_inigo_quilez(0.5)(d)
    np.testing.assert_array_equal(img[2, 3], (255, 0, 0, 255))
    grad = colors.color_conversion_linear_gradient(0, 240, 0.5)(np.nan_to_num(d))
    assert not np.array_equal(grad[0, 0], grad[-1, -1])
    r, g, b = colors.hsv_to_rgb([0.0, 120.0, 240.0], 1.0, 1.0)
    np.testing.assert_allclose(np.stack([r, g, b]), np.eye(3), atol=1e-6)


def test_eval_exports_and_imports():
    """gsdf_tpu_torch.eval exports what gsdf_tpu.eval does, less
    clear_jit_cache; importing the slice's packages loads no JAX."""
    assert set(torch_eval.__all__) == set(jax_eval.__all__) - {"clear_jit_cache"}
    code = (
        "import sys; import gsdf_tpu_torch.eval, gsdf_tpu_torch.eval.special, "
        "gsdf_tpu_torch.render, gsdf_tpu_torch.pipeline, gsdf_tpu_torch.pipeline.colors; "
        "from gsdf_tpu_torch.render import (bw_conversion, iq_debug_conversion, "
        "render_distance_field, render_image_2d, write_png); "
        "from gsdf_tpu_torch.pipeline import RenderConfig, render_shader3d, render_png_file_2d; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gsdf_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
