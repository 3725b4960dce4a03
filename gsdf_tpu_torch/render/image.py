"""2D SDF -> image rendering (reference glrender/image.go:20-118; torch
counterpart of gsdf_tpu/render/image.py).

The row-batched evaluation of the reference becomes one whole-image launch
of the pixel-grid kernel K2-2D (eval/point_kernels.py), which makes the
pixels' positions on the device, and one fetch; color conversion is
vectorized numpy on host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..core.node import Shader2D
from ..eval.point_kernels import distance_field

_f32 = np.float32

ColorConv = Callable[[np.ndarray], np.ndarray]  # (H,W) dist -> (H,W,4) uint8


def bw_conversion(d: np.ndarray) -> np.ndarray:
    """Default scheme: black interior, white exterior, red NaN/Inf
    (reference image.go:56-65)."""
    h, w = d.shape
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    bad = ~np.isfinite(d)
    pos = d > 0
    img[pos] = (255, 255, 255, 255)
    img[bad] = (255, 0, 0, 255)
    return img


def iq_debug_conversion(d: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Inigo Quilez's debug palette (reference image.go:31-50,
    gsdfaux/color.go:20)."""
    dd = d / scale
    c = np.where(
        dd[..., None] > 0,
        np.array([0.9, 0.6, 0.3], _f32),
        np.array([0.65, 0.85, 1.0], _f32),
    )
    c = c * (1 - np.exp(-6 * np.abs(dd)))[..., None]
    c = c * (0.8 + 0.2 * np.cos(150 * dd))[..., None]
    t = np.clip(np.abs(dd) / 0.01, 0, 1)
    mx = 1 - t * t * (3 - 2 * t)  # smoothstep(0, 0.01, |d|)
    c = c + (1.0 - c) * mx[..., None]
    img = np.empty(dd.shape + (4,), np.uint8)
    img[..., :3] = np.clip(c * 255, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def render_distance_field(
    obj: Shader2D, width: int, height: int, device=None
) -> np.ndarray:
    """Evaluate the SDF over a width x height pixel grid covering its bounds.

    Returns (height, width) float32 distances with row 0 at the TOP
    (image convention), matching the reference's y inversion
    (image.go:89-97). On a CUDA device (the default) it is one kernel
    launch and one fetch; no positions are uploaded."""
    return distance_field(obj, width, height, device).cpu().numpy()


def render_image_2d(
    obj: Shader2D,
    width: int,
    height: int,
    conversion: Optional[ColorConv] = None,
    device=None,
) -> np.ndarray:
    """Render a 2D SDF to an (H,W,4) RGBA uint8 array."""
    d = render_distance_field(obj, width, height, device)
    conv = conversion if conversion is not None else bw_conversion
    return conv(d)


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img, mode="RGBA").save(path)
