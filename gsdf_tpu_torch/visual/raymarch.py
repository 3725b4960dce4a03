"""Sphere-tracing renderer on the card: the headless counterpart of the
reference's interactive GLFW raymarch UI (gsdfaux/ui.go:17-245); torch
counterpart of gsdf_tpu/visual/raymarch.py.

The reference evaluates the SDF in a fragment shader (256 steps,
ui.go:322-333); here the same sphere-tracing loop runs as one launch of
K8 (eval/ray_kernels.py, csrc/raymarch.cu) over the whole supersample
grid, shading and the box filter included. `turntable` renders an orbit
(and optionally writes an animated GIF), the batch form of the UI's mouse
orbit.

The frame's constants (the camera basis, the part's centre and scale, the
light) are made once on the host in float32 (`camera`) and go to the
kernel as arguments: the card and the plain version take the same
numbers. The frame size, steps, relaxation and aa are launch arguments
too, so one library serves every frame of a tree (of a structure, with
parametric=True).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .. import spans
from ..core.node import Shader3D
from ..eval.ray_kernels import pack_camera, raymarch

_f32 = np.float32
_UP_Z = np.array([0, 0, 1], _f32)
_UP_X = np.array([1, 0, 0], _f32)


def _cos(x: np.float32) -> np.float32:
    return _f32(math.cos(float(x)))  # float64, rounded once


def _sin(x: np.float32) -> np.float32:
    return _f32(math.sin(float(x)))


def _cross(a, b) -> np.ndarray:
    """jnp.cross's expressions, in float32."""
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], _f32)


def _norm(v) -> np.float32:
    return np.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])


def camera_basis(yaw: float, pitch: float, cam_dist: float):
    """(ro, uu, vv, ww) float32 (3,): the ray origin on the orbit about +z
    and the camera basis, in the JAX package's float32 operations
    (raymarch.py:70-86). Up is +z, and +x where |sin(pitch)| > 0.999
    (looking straight down or up, +z is parallel to ww). cos and sin are
    rounded once from float64 (XLA-CPU's are within an ulp of them)."""
    yaw, pitch, cam = _f32(yaw), _f32(pitch), _f32(cam_dist)
    cy, sy, cp, sp = _cos(yaw), _sin(yaw), _cos(pitch), _sin(pitch)
    ro = cam * np.array([cy * cp, sy * cp, sp], _f32)
    ww = -ro / _norm(ro)
    up = _UP_X if abs(sp) > _f32(0.999) else _UP_Z
    uu = _cross(ww, up)
    uu = uu / _norm(uu)
    vv = _cross(uu, ww)
    return ro, uu, vv, ww


def camera(obj: Shader3D, yaw: float, pitch: float, cam_dist: float) -> np.ndarray:
    """The 20 float32 numbers of one frame (eval.ray_kernels.pack_camera):
    the camera basis, the part's bounds centre and half its largest side
    (the scene is drawn normalised to radius <= sqrt(3)), the unit light
    direction, and the far plane cam_dist + 4 (raymarch.py:101-105,
    :212-216)."""
    bb = obj.bounds()
    center = bb.center().astype(_f32)
    scale = _f32(max(float(np.max(bb.size())) / 2, 1e-9))
    light = np.array([0.6, 0.4, 0.8], _f32)
    light /= np.linalg.norm(light)
    return pack_camera(*camera_basis(yaw, pitch, cam_dist), center, light, scale,
                       _f32(cam_dist) + _f32(4.0))


def auto_relax(obj: Shader3D) -> float:
    """Sphere-tracing relaxation appropriate for this tree.

    Domain-warping ops (helical screw sweeps, twist) and shells of scaled
    fields are not 1-Lipschitz: full steps overshoot thin features and
    speckle (the reference's fragment raymarcher has the same artifact).
    Under-step those trees automatically."""
    warping = {"ScrewNode", "Twist"}
    for n in obj.visit_bfs():
        if type(n).__name__ in warping:
            return 0.6
    return 0.8


def raymarch_image_device(
    obj: Shader3D,
    width: int = 512,
    height: int = 512,
    yaw: float = 0.6,
    pitch: float = 0.5,
    cam_dist: float = 2.4,
    steps: int = 196,
    device=None,
    relax: float | None = None,
    aa: int = 1,
    parametric: bool = False,
):
    """Launch one shaded view and return the (H, W, 3) uint8 tensor on
    `device` (None: the card) WITHOUT synchronising: a caller can overlap
    frame N+1's launch with frame N's fetch (the interactive viewer's
    drag-frame pipelining). One K8 call (K8p with parametric=True: a
    tree.rebind edit re-renders through the same library, with no build)."""
    with spans.span("raymarch.scene"):
        relax = auto_relax(obj) if relax is None else relax
        cam = camera(obj, yaw, pitch, cam_dist)
    return raymarch(obj, cam, width, height, steps, relax, int(aa), device,
                    parametric=parametric)


def raymarch_image(
    obj: Shader3D,
    width: int = 512,
    height: int = 512,
    yaw: float = 0.6,
    pitch: float = 0.5,
    cam_dist: float = 2.4,
    steps: int = 196,
    device=None,
    relax: float | None = None,
    aa: int = 1,
    parametric: bool = False,
) -> np.ndarray:
    """Render one shaded view of the part, returning (H,W,3) uint8.

    relax=None picks a step relaxation automatically (auto_relax).
    aa > 1 supersamples (renders aa*W x aa*H and box-filters down on the
    card — the reference UI's uAA antialiasing, gsdfaux/ui.go:131-241 —
    so the fetched frame is always W x H regardless of aa)."""
    return raymarch_image_device(
        obj, width, height, yaw, pitch, cam_dist, steps, device, relax, aa,
        parametric=parametric,
    ).cpu().numpy()


def turntable(
    obj: Shader3D,
    n_frames: int = 24,
    width: int = 384,
    height: int = 384,
    pitch: float = 0.5,
    gif_path: Optional[str] = None,
    device=None,
):
    """Render an orbit of the part; optionally write an animated GIF."""
    frames = [
        raymarch_image(
            obj, width, height, yaw=2 * math.pi * i / n_frames, pitch=pitch,
            device=device,
        )
        for i in range(n_frames)
    ]
    if gif_path:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            gif_path, save_all=True, append_images=imgs[1:], duration=80, loop=0
        )
    return frames
