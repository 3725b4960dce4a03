"""The port's raymarcher (visual/raymarch.py, K8's plain version
eval/ray_kernels.py, the ray header csrc/gsdf_raymarch.cuh) against the
JAX package's gsdf_tpu/visual/raymarch.py on the CPU.

JAX runs op by op (`jax.disable_jit`), as in the other test_torch_* files,
on one pinned ray grid: 96 x 80 at aa 1 and 48 x 40 at aa 2 are both 96 x
80 supersamples, so its primitives compile once for the file.

Tolerances, as found:
- the images: every pixel within one level of the JAX package's; the
  pixels past one level are pinned (PAST_ONE_LEVEL: none on these trees);
  at most 0.1% of the pixels differ at all (sphere tracing iterates, so an
  ulp of XLA-CPU's cos, sin or pow can move a silhouette ray or a level);
- the camera basis: within 2 ulps of the JAX package's float32
  expressions (XLA-CPU's cos and sin against the port's, rounded once from
  float64), and equal bit for bit with XLA's cos and sin substituted;
- the supersampling box filter: bit-identical to box-filtering the aa*W x
  aa*H image on the host;
- the g++ build of the ray header around a tree's generated source: equal
  to the plain version pixel for pixel and in every ray's evaluation count
  (the knurled cylinder: one pixel off by a level, PINNED_GXX: its
  CircularArray's atan2f is glibc's in the g++ build, torch's on the CPU).
  The gamma's powf is glibc's in the g++ build and float64 rounded once
  in the plain version; on these frames no pixel differs for it.
"""
import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu import flagships as jax_flagships
from gsdf_tpu.visual import raymarch as jrm
from gsdf_tpu_torch import Builder, flagships
from gsdf_tpu_torch.codegen.cuda import tree_source
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.eval import ray_kernels as rk
from gsdf_tpu_torch.pipeline import UIConfig, ui
from gsdf_tpu_torch.visual import raymarch as trm

JAX_CPU = jax.devices("cpu")[0]
STEPS = 40
#: (width, height, aa): both are 96 x 80 supersamples
FRAMES = ((96, 80, 1), (48, 40, 2))
#: pixels more than one level from the JAX package's, as found
PAST_ONE_LEVEL = {"scene": 0, "bolt": 0, "twist": 0, "parametric": 0, "straight-down": 0}
#: pixels where the g++ build differs from the plain version, as found
PINNED_GXX = {"scene": 0, "twist": 0, "bolt": 0, "flange": 0, "knurled": 1}


def _scene(b):
    """The scene of tests/test_visual.py:166-171."""
    return b.smooth_union(0.1, b.new_sphere(0.7), b.new_box(1.0, 0.6, 0.4, 0.05))


def _twist(b):
    return b.twist(b.new_box(1.0, 0.6, 0.4, 0.05), 0.5)


def _boss(b):
    """The slider part of tests/test_interactive.py: (part, its boss)."""
    boss = b.new_cylinder(0.45, 1.2, 0.05)
    return b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), boss), boss


def _pair(name):
    """(JAX tree, port tree carried over by convert.from_reference_tree)."""
    if name == "bolt":
        jt = jax_flagships.build_bolt()
    elif name == "twist":
        jt = _twist(JaxBuilder())
    elif name == "parametric":
        jt, boss = _boss(JaxBuilder())
        tt = from_reference_tree(jt)
        jt.rebind({boss: {"r": 0.3}})
        tt.rebind({tt.s2: {"r": 0.3}})
        return jt, tt
    else:
        jt = _scene(JaxBuilder())
    return jt, from_reference_tree(jt)


def _levels(got, ref):
    """(pixels past one level, pixels differing) of two u8 images."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max(axis=-1)
    return int((diff > 1).sum()), int((diff > 0).sum())


def _check_against_jax(name, got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    past, differ = _levels(got, ref)
    assert past == PAST_ONE_LEVEL[name]
    assert differ <= got.shape[0] * got.shape[1] // 1000
    # the part is in view: lit pixels and sky pixels both
    assert (got.sum(-1) < 500).sum() > 50 and (got.sum(-1) > 600).sum() > 50


@pytest.mark.parametrize("frame", FRAMES, ids=["aa1", "aa2"])
@pytest.mark.parametrize("name", ["scene", "bolt", "twist", "parametric"])
def test_raymarch_matches_jax(name, frame):
    w, h, aa = frame
    jt, tt = _pair(name)
    parametric = name == "parametric"
    assert trm.auto_relax(tt) == jrm.auto_relax(jt)
    with jax.disable_jit():
        ref = jrm.raymarch_image(jt, w, h, aa=aa, steps=STEPS, device=JAX_CPU,
                                 parametric=parametric)
    got = trm.raymarch_image(tt, w, h, aa=aa, steps=STEPS, device="cpu", parametric=parametric)
    _check_against_jax(name, got, ref)


def test_raymarch_straight_down_matches_jax():
    """pitch = pi/2: +z is parallel to the view direction, and up turns to
    +x (raymarch.py:78-82) in both packages."""
    jt, tt = _pair("scene")
    with jax.disable_jit():
        ref = jrm.raymarch_image(jt, 96, 80, pitch=math.pi / 2, steps=STEPS, device=JAX_CPU)
    got = trm.raymarch_image(tt, 96, 80, pitch=math.pi / 2, steps=STEPS, device="cpu")
    _check_against_jax("straight-down", got, ref)
    ro, uu, vv, ww = trm.camera_basis(0.6, math.pi / 2, 2.4)
    assert np.all(np.isfinite(uu)) and uu[0] == 0 and abs(uu[1]) == 1


def test_raymarch_aa_filter_bit_identical():
    """tests/test_visual.py:158-176 on the port: the supersampled frame's
    box filter equals rendering at aa*W x aa*H and filtering the u8 image
    on the host, floor(mean + 0.5)."""
    s = _scene(Builder())
    dev_aa = trm.raymarch_image(s, 48, 40, aa=2, steps=40, device="cpu")
    full = trm.raymarch_image(s, 96, 80, aa=1, steps=40, device="cpu")
    boxed = full.reshape(40, 2, 48, 2, 3).astype(np.uint16)
    ref = (boxed.mean(axis=(1, 3)) + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(dev_aa, ref)


def test_camera_basis_matches_jax(monkeypatch):
    """camera_basis against the JAX package's camera expressions
    (raymarch.py:70-86) with jnp on the CPU, over the default view, both
    straight views and 200 seeded ones."""
    f32 = np.float32

    def jax_basis(yaw, pitch, cam):
        with jax.disable_jit():
            cy, sy = jnp.cos(f32(yaw)), jnp.sin(f32(yaw))
            cp, sp = jnp.cos(f32(pitch)), jnp.sin(f32(pitch))
            ro = f32(cam) * jnp.stack([cy * cp, sy * cp, sp])
            ww = -ro / jnp.sqrt(jnp.sum(ro * ro))
            up = jnp.where(jnp.abs(sp) > 0.999, jnp.asarray(np.array([1, 0, 0], f32)),
                           jnp.asarray(np.array([0, 0, 1], f32)))
            uu = jnp.cross(ww, up)
            uu = uu / jnp.sqrt(jnp.sum(uu * uu))
            return [np.asarray(v) for v in (ro, uu, jnp.cross(uu, ww), ww)]

    def ulps(a, b):
        a, b = (np.asarray(v, f32).view(np.int32).astype(np.int64) for v in (a, b))
        return int(np.abs(a - b).max())

    rng = np.random.default_rng(0)
    views = [(0.6, 0.5, 2.4), (0.0, math.pi / 2, 2.4), (1.0, -math.pi / 2, 3.0)]
    views += [(rng.uniform(-7, 7), rng.uniform(-1.57, 1.57), rng.uniform(1.2, 8))
              for _ in range(200)]
    refs = [jax_basis(*v) for v in views]
    found = [max(ulps(a, b) for a, b in zip(trm.camera_basis(*v), r)) for v, r in zip(views, refs)]
    assert max(found) <= 2

    def xla(fn):
        def call(x):
            with jax.disable_jit():
                return f32(np.asarray(fn(f32(x))))
        return call

    monkeypatch.setattr(trm, "_cos", xla(jnp.cos))
    monkeypatch.setattr(trm, "_sin", xla(jnp.sin))
    for v, r in zip(views, refs):
        for a, b in zip(trm.camera_basis(*v), r):
            np.testing.assert_array_equal(a, b)


def test_frame_constants_match_jax():
    """The centre, scale, light and far plane that the JAX package passes
    its executable (raymarch.py:212-229), on the four golden parts."""
    for name in ("flange", "showerhead", "bolt", "knurled"):
        jt = getattr(jax_flagships, f"build_{name}")()
        c = rk.unpack_camera(trm.camera(from_reference_tree(jt), 0.6, 0.5, 2.4))
        bb = jt.bounds()
        np.testing.assert_array_equal(c["center"], bb.center().astype(np.float32))
        assert c["scale"] == np.float32(max(float(np.max(bb.size())) / 2, 1e-9))
        light = np.array([0.6, 0.4, 0.8], np.float32)
        np.testing.assert_array_equal(c["light"], light / np.linalg.norm(light))
        assert c["far_plane"] == np.float32(2.4) + np.float32(4.0)


def test_auto_relax_matches_jax_on_the_parts():
    for name in ("flange", "showerhead", "bolt", "knurled"):
        jt = getattr(jax_flagships, f"build_{name}")()
        assert trm.auto_relax(from_reference_tree(jt)) == jrm.auto_relax(jt)
    assert trm.auto_relax(flagships.build_bolt()) == 0.6


def test_plain_counts_the_evaluations_k8_makes():
    """Every supersample evaluates the tree once a march step and 5 times
    after it: between 6 and steps + 5; sky rays stop at the far plane,
    rays that hit the part stop early."""
    tree = _scene(Builder())
    cam = trm.camera(tree, 0.6, 0.5, 2.4)
    img, evals = rk.raymarch_plain(tree, cam, 48, 40, STEPS, 0.8, 2, "cpu", evals=True)
    assert evals.shape == (80, 96) and evals.dtype == torch.int32
    assert int(evals.min()) >= 6 and int(evals.max()) <= STEPS + 5
    np.testing.assert_array_equal(img.numpy(), trm.raymarch_image(tree, 48, 40, aa=2,
                                                                  steps=STEPS, device="cpu"))
    short = rk.raymarch_plain(tree, cam, 48, 40, 3, 0.8, 1, "cpu", evals=True)[1]
    assert int(short.max()) == 3 + 5


def test_raymarch_wrapper_rejects_bad_frames():
    tree = _scene(Builder())
    cam = trm.camera(tree, 0.6, 0.5, 2.4)
    for w, h, steps, aa in ((0, 4, 4, 1), (4, 4, -1, 1), (4, 4, 4, 0)):
        with pytest.raises(ValueError, match="raymarched frame"):
            rk.raymarch(tree, cam, w, h, steps, 0.8, aa, "cpu")
    with pytest.raises(ValueError, match="20 floats"):
        rk.raymarch(tree, cam[:19], 4, 4, 4, 0.8, 1, "cpu")
    with pytest.raises(TypeError, match="3D trees"):
        rk.raymarch(Builder().new_circle(1.0), cam, 4, 4, 4, 0.8, 1, "cpu")


def test_raymarch_without_a_device_needs_the_card():
    """The entry point's default is the card: with none it raises, and
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trm.raymarch_image(_scene(Builder()), 16, 16, steps=4)


def test_short_circuit_counter_needs_the_card():
    """The short-circuit counter is K8's counting form: on the CPU it
    raises, and counts nothing."""
    tree = _scene(Builder())
    cam = trm.camera(tree, 0.6, 0.5, 2.4)
    rk.SHORT_CIRCUITS.clear()
    with pytest.raises(ValueError, match="CUDA device"):
        rk.count_short_circuits(tree, cam, 16, 16, 4, 0.8, 1, "cpu")
    assert rk.SHORT_CIRCUITS == {}


def test_turntable_and_ui_write_a_gif(tmp_path):
    """ui (a turntable of UIConfig's frames) writes an animated GIF whose
    frames are raymarch_image's at the orbit's yaws."""
    tree = _scene(Builder())
    path = tmp_path / "turntable.gif"
    frames = ui(tree, UIConfig(width=48, height=40, frames=3, gif_path=str(path), device="cpu"))
    assert len(frames) == 3 and frames[0].shape == (40, 48, 3)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            f, trm.raymarch_image(tree, 48, 40, yaw=2 * math.pi * i / 3, device="cpu"))
    assert not np.array_equal(frames[0], frames[1])
    with Image.open(path) as gif:
        assert gif.n_frames == 3 and gif.size == (48, 40)
    again = trm.turntable(tree, 2, 48, 40, device="cpu", gif_path=str(tmp_path / "t2.gif"))
    np.testing.assert_array_equal(again[0], frames[0])
    assert UIConfig() == UIConfig(800, 600, 24, 0.5, None, None)


# --- the ray header, built by g++ -----------------------------------------
GXX_TREES = {
    "scene": lambda: _scene(Builder()),
    "twist": lambda: _twist(Builder()),
    "bolt": flagships.build_bolt,
    "flange": flagships.build_flange,
    "knurled": flagships.build_knurled,
}


@pytest.fixture(scope="module")
def ray_lib(tmp_path_factory):
    """csrc/gsdf_raymarch.cuh around each tree's generated source, built by
    g++ (-O1 -ffp-contract=off), its gamma's powf glibc's, the lanes driven
    by a host scheduler that mirrors the kernel's warp: `warp` lanes march,
    and in a turn with an idle lane the lanes' marched rays go onto a stack
    and the idle lanes take the next rays, in lane order, of a batch of 32
    set up from the queue in the kernel's ray order (gsdf_rm::queue_ray,
    ray_dir); `warp` marched rays at a time (the rest at the end) get their
    five shading evaluations and their colour.
    {name: (tree, render)}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    d = tmp_path_factory.mktemp("raymarch")
    shim = ["#include <math.h>", "#include <stdint.h>", "#include <string.h>",
            '#include "gsdf_raymarch.cuh"',
            'extern "C" int64_t queue_length(int rw, int rh) '
            "{ return gsdf_rm::queue_length(rw, rh); }",
            'extern "C" int queue_ray(int64_t id, int rw, int rh, int* ix, int* iy) '
            "{ return gsdf_rm::queue_ray(id, rw, rh, ix, iy); }"]
    trees = {name: make() for name, make in GXX_TREES.items()}
    for i, tree in enumerate(trees.values()):
        (d / f"tree{i}.cuh").write_text(tree_source(tree))
        shim.append(
            f'namespace tree{i} {{\n#include "tree{i}.cuh"\n'
            "struct Scene {\n    float operator()(float x, float y, float z) const "
            "{ return gsdf_tree(x, y, z); }\n};\n}\n"
            f'extern "C" void render{i}(const float* cam, int width, int height, int steps, '
            "float relax, int aa, int warp, uint8_t* samples, uint8_t* out, int* evals) {\n"
            f"    gsdf_rm::Camera c;\n    memcpy(&c, cam, sizeof c);\n    tree{i}::Scene s;\n"
            "    const int rw = width * aa, rh = height * aa;\n"
            "    const int64_t n_ids = gsdf_rm::queue_length(rw, rh);\n"
            "    gsdf_rm::Lane lanes[32] = {};\n    bool busy[32] = {}, marched[32] = {};\n"
            "    float next_rd[32][3];\n    int next_at[32], taken = 32;\n"
            "    int64_t next_id = 0;\n"
            "    gsdf_rm::Lane stack[64];\n    int n_marched = 0;\n"
            "    for (;;) {\n"
            "        int idle = 0;\n"
            "        for (int l = 0; l < warp; ++l) idle += !busy[l];\n"
            "        bool drained = next_id >= n_ids && taken == 32;\n"
            "        if (idle == warp || (!drained && idle > 0)) {\n"
            "            for (int l = 0; l < warp; ++l)\n"
            "                if (marched[l]) {\n"
            "                    stack[n_marched++] = lanes[l];\n"
            "                    marched[l] = false;\n                }\n"
            "            for (int l = 0; l < warp; ++l) {\n"
            "                if (busy[l]) continue;\n"
            "                if (taken == 32) {  // the next batch of 32 queue ids, set up\n"
            "                    if (next_id >= n_ids) continue;\n"
            "                    for (int j = 0; j < 32; ++j) {\n"
            "                        int ix, iy;\n                        next_at[j] = -1;\n"
            "                        if (gsdf_rm::queue_ray((int)next_id + j, rw, rh, &ix, &iy)) {\n"
            "                            gsdf_rm::ray_dir(c, ix, iy, rw, rh, next_rd[j]);\n"
            "                            next_at[j] = iy * rw + ix;\n                        }\n"
            "                    }\n                    next_id += 32;\n                    taken = 0;\n"
            "                }\n"
            "                const int j = taken++;\n"
            "                if (next_at[j] >= 0) {\n"
            "                    gsdf_rm::lane_start(lanes[l], next_rd[j], next_at[j]);\n"
            "                    busy[l] = steps > 0;\n                    marched[l] = steps == 0;\n"
            "                }\n            }\n"
            "            int n_busy = 0;\n            bool held = false;\n"
            "            for (int l = 0; l < warp; ++l) {\n"
            "                n_busy += busy[l];\n                held = held || marched[l];\n            }\n"
            "            drained = next_id >= n_ids && taken == 32;\n"
            "            if (n_marched >= warp || (n_busy == 0 && drained && n_marched > 0)) {\n"
            "                // a shading round on the stack's top `warp` rays\n"
            "                const int rest = n_marched > warp ? n_marched - warp : 0;\n"
            "                for (int i = rest; i < n_marched; ++i) {\n"
            "                    const gsdf_rm::Lane& r = stack[i];\n"
            "                    float pos[3], p[3], d0 = 0.0f, n[3] = {0.0f, 0.0f, 0.0f};\n"
            "                    for (int a = 0; a < 3; ++a) pos[a] = c.ro[a] + r.rd[a] * r.t;\n"
            "                    for (int q = 0; q < 5; ++q) {\n"
            "                        gsdf_rm::shade_point(pos, q, p);\n"
            "                        gsdf_rm::shade_step(q, gsdf_rm::scene_at(s, c, p), &d0, n);\n"
            "                    }\n"
            "                    gsdf_rm::shade(c, r.rd, n, d0, samples + 3 * (int64_t)r.at);\n"
            "                    evals[r.at] = r.steps + 5;\n                }\n"
            "                n_marched = rest;\n                continue;\n            }\n"
            "            if (n_busy == 0) {\n"
            "                if (drained && !held) break;\n                continue;\n            }\n"
            "        }\n"
            "        for (int l = 0; l < warp; ++l) {\n"
            "            if (!busy[l]) continue;\n"
            "            float p[3];\n            gsdf_rm::march_point(lanes[l], c, p);\n"
            "            if (gsdf_rm::march_step(lanes[l], c, gsdf_rm::scene_at(s, c, p), steps, relax)) {\n"
            "                busy[l] = false;\n                marched[l] = true;\n            }\n"
            "        }\n    }\n"
            "    if (aa > 1)\n        for (int y = 0; y < height; ++y)\n"
            "            for (int x = 0; x < width; ++x)\n"
            "                gsdf_rm::box_filter(samples, out, x, y, width, aa);\n}"
        )
    (d / "shim.cpp").write_text("\n".join(shim) + "\n")
    so = d / "libray.so"
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
         "-I", rk.__file__.rsplit("/eval/", 1)[0] + "/csrc", "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))

    def renderer(i):
        fn = getattr(lib, f"render{i}")
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        fn.restype = None

        def run(cam, w, h, steps, relax, aa, warp):
            samples = np.zeros((h * aa, w * aa, 3), np.uint8)
            out = samples if aa == 1 else np.zeros((h, w, 3), np.uint8)
            evals = np.zeros((h * aa, w * aa), np.int32)
            fn(cam.ctypes.data, w, h, steps, relax, aa, warp, samples.ctypes.data,
               out.ctypes.data, evals.ctypes.data)
            return out, evals

        return run

    out = {name: (tree, renderer(i)) for i, (name, tree) in enumerate(trees.items())}
    lib.queue_length.argtypes = [ctypes.c_int] * 2
    lib.queue_length.restype = ctypes.c_int64
    lib.queue_ray.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.queue_ray.restype = ctypes.c_int
    out["queue"] = lib
    return out


def _header_against_plain(tree, run, w, h, steps, aa, warp):
    """(pixels past one level, pixels differing) of the g++ lanes' image
    against raymarch_plain's; fails unless every ray's evaluation count
    is plain's (a ray the scheduler never finished would count 0)."""
    cam = trm.camera(tree, 0.6, 0.5, 2.4)
    relax = trm.auto_relax(tree)
    got, evals = run(cam, w, h, steps, relax, aa, warp)
    ref, ref_evals = rk.raymarch_plain(tree, cam, w, h, steps, relax, aa, "cpu", evals=True)
    np.testing.assert_array_equal(evals, ref_evals.numpy())
    return _levels(got, ref.numpy())


@pytest.mark.parametrize("warp", [1, 32], ids=["lanes1", "lanes32"])
@pytest.mark.parametrize("frame", FRAMES, ids=["aa1", "aa2"])
@pytest.mark.parametrize("name", list(GXX_TREES))
def test_ray_header_matches_plain(name, frame, warp, ray_lib):
    """K8's per-ray arithmetic (the very header nvcc builds, no multiply-add
    contraction on either), its lanes refilled from the kernel's ray
    queue, against raymarch_plain: the same pixels but the pinned ones,
    the same evaluations on every ray."""
    tree, run = ray_lib[name]
    w, h, aa = frame
    past, differ = _header_against_plain(tree, run, w, h, STEPS, aa, warp)
    assert past == 0 and differ == PINNED_GXX[name]


#: frames the kernel's queue meets at its edges, (width, height, steps, aa):
#: 37 x 23 rays (not a multiple of 32, ragged tiles on both axes), a 1 x 1
#: frame, and no march step at all
EDGE_FRAMES = {"ragged": (37, 23, STEPS, 1), "one-ray": (1, 1, STEPS, 1),
               "no-steps": (48, 40, 0, 2)}


@pytest.mark.parametrize("warp", [1, 32], ids=["lanes1", "lanes32"])
@pytest.mark.parametrize("frame", list(EDGE_FRAMES))
def test_ray_header_edge_frames(frame, warp, ray_lib):
    """The lanes at the queue's edges on the bolt: every ray written once
    with plain's evaluations, the image plain's."""
    tree, run = ray_lib["bolt"]
    w, h, steps, aa = EDGE_FRAMES[frame]
    assert _header_against_plain(tree, run, w, h, steps, aa, warp) == (0, 0)


def test_queue_order_covers_each_ray_once(ray_lib):
    """gsdf_rm::queue_ray: tiles of 8 x 4 supersamples, row-major over the
    frame and inside each tile; every ray of a ragged frame has exactly
    one id, and the ids past its edge are no ray."""
    lib = ray_lib["queue"]
    for rw, rh in ((37, 23), (1, 1), (64, 8), (800, 3)):
        n = lib.queue_length(rw, rh)
        assert n == -(-rw // 8) * -(-rh // 4) * 32
        seen = np.zeros((rh, rw), np.int32)
        ix, iy = ctypes.c_int(), ctypes.c_int()
        for i in range(n):
            tile, k = divmod(i, 32)
            tx, ty = tile % -(-rw // 8), tile // -(-rw // 8)
            want = (tx * 8 + k % 8, ty * 4 + k // 8)
            inside = lib.queue_ray(i, rw, rh, ctypes.byref(ix), ctypes.byref(iy))
            assert (ix.value, iy.value) == want
            assert bool(inside) == (want[0] < rw and want[1] < rh)
            if inside:
                seen[iy.value, ix.value] += 1
        assert (seen == 1).all()


def test_lane_efficiency_on_hand_made_counts():
    """chip_smoke.lane_efficiency, the measure of how a group of rays that
    runs as long as its slowest ray fills its slots, on hand-made counts."""
    import chip_smoke

    evals = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    got = chip_smoke.lane_efficiency(evals, {"2x1": (2, 1), "4x2": (4, 2), "3x2": (3, 2)})
    # 2 x 1: the tiles' most 2, 4, 6, 8 -> 36 / 40; 4 x 2: 36 / (8 * 8);
    # 3 x 2, a ragged edge whose lanes past it idle: 36 / (6 * 7 + 6 * 8)
    assert got == {"2x1": 36 / 40, "4x2": 36 / 64, "3x2": 36 / 90}
    assert set(chip_smoke.lane_efficiency(np.full((8, 64), 3)).values()) == {1.0}
    assert chip_smoke.lane_efficiency(np.zeros((2, 2), int)) == dict.fromkeys(
        chip_smoke.LANE_TILES, 1.0)
