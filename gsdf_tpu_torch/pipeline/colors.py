"""Color conversions for 2D SDF visualization (reference gsdfaux/color.go;
a copy of gsdf_tpu/pipeline/colors.py: host numpy, no device work).

Vectorized over whole distance fields; used with render.image conversions.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def color_conversion_inigo_quilez(char_length: float):
    """IQ's famous SDF debug palette (reference gsdfaux/color.go:20-48;
    shown at Gophercon AU 2024). char_length normalizes distances."""

    def conv(d: np.ndarray) -> np.ndarray:
        dd = d / _f32(char_length)
        c = np.where(
            dd[..., None] > 0,
            np.array([0.9, 0.6, 0.3], _f32),
            np.array([0.65, 0.85, 1.0], _f32),
        )
        c = c * (1 - np.exp(-6 * np.abs(dd)))[..., None]
        c = c * (0.8 + 0.2 * np.cos(150 * dd))[..., None]
        t = np.clip(np.abs(dd) / 0.01, 0, 1)
        mx = 1 - t * t * (3 - 2 * t)
        c = c + (1.0 - c) * mx[..., None]
        img = np.empty(dd.shape + (4,), np.uint8)
        img[..., :3] = np.clip(np.nan_to_num(c) * 255, 0, 255).astype(
            np.uint8
        )
        img[..., 3] = 255
        # NaN distances render RED — the palette's bad-field debug flag
        # (reference color.go:22,31 'Returns red for NaN values')
        img[np.isnan(dd)] = (255, 0, 0, 255)
        return img

    return conv


def hsv_to_rgb(h, s, v):
    """Vectorized HSV -> RGB in [0,1]. h in degrees."""
    h = np.asarray(h, _f32) % 360.0
    s = np.asarray(s, _f32)
    v = np.asarray(v, _f32)
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    conds = [
        (hp < 1, (c, x, z)),
        ((hp >= 1) & (hp < 2), (x, c, z)),
        ((hp >= 2) & (hp < 3), (z, c, x)),
        ((hp >= 3) & (hp < 4), (z, x, c)),
        ((hp >= 4) & (hp < 5), (x, z, c)),
        (hp >= 5, (c, z, x)),
    ]
    r = np.zeros_like(c)
    g = np.zeros_like(c)
    b = np.zeros_like(c)
    for cond, (rr, gg, bb) in conds:
        r = np.where(cond, rr, r)
        g = np.where(cond, gg, g)
        b = np.where(cond, bb, b)
    m = v - c
    return r + m, g + m, b + m


def color_conversion_linear_gradient(hue0: float, hue1: float, char_length: float):
    """Linear HSV gradient between two hues by signed distance
    (reference gsdfaux/color.go:50)."""

    def conv(d: np.ndarray) -> np.ndarray:
        t = np.clip(0.5 + 0.5 * d / _f32(char_length), 0, 1)
        h = hue0 + (hue1 - hue0) * t
        r, g, b = hsv_to_rgb(h, np.ones_like(t), np.ones_like(t))
        img = np.empty(d.shape + (4,), np.uint8)
        img[..., 0] = np.clip(r * 255, 0, 255).astype(np.uint8)
        img[..., 1] = np.clip(g * 255, 0, 255).astype(np.uint8)
        img[..., 2] = np.clip(b * 255, 0, 255).astype(np.uint8)
        img[..., 3] = 255
        return img

    return conv
