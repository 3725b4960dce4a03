"""Plain PyTorch sphere tracer: the benchmark's reference frame of a part
seen from an orbit camera, shaded and box-filtered to u8, with the
published kernel's viewer defaults (visual/raymarch.py of the JAX package
it was ported from: the part normalised to its bounds, a tetrahedral
normal, one light, gamma 2.2, a box filter over aa x aa supersamples). It
imports nothing of the program under test.

Each march step runs on the rays that are not done: a ray stops where
|d| < 1e-4 or past the far plane (camera distance + 4), or after `steps`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import sdf

_f32 = np.float32
#: the tetrahedral normal's offsets
NORMAL_K = np.array([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], _f32)
MARCH_EPS, HIT_EPS, NORMAL_H = _f32(1e-4), _f32(1e-3), _f32(1e-4)
BASE, SKY = np.array([0.85, 0.6, 0.3], _f32), np.array([0.65, 0.78, 0.9], _f32)
GAMMA = _f32(1 / 2.2)
_UP_Z, _UP_X = np.array([0, 0, 1], _f32), np.array([1, 0, 0], _f32)


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], _f32)


def _norm(v):
    return np.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])


def camera(box, yaw: float, pitch: float, cam_dist: float) -> dict:
    """The frame's float32 constants: the orbit camera about +z (up +x when
    looking straight down or up), the part's centre and half its largest
    side, the unit light, the far plane."""
    yaw, pitch, cam = _f32(yaw), _f32(pitch), _f32(cam_dist)
    cy, sy = _f32(math.cos(float(yaw))), _f32(math.sin(float(yaw)))
    cp, sp = _f32(math.cos(float(pitch))), _f32(math.sin(float(pitch)))
    ro = cam * np.array([cy * cp, sy * cp, sp], _f32)
    ww = -ro / _norm(ro)
    uu = _cross(ww, _UP_X if abs(sp) > _f32(0.999) else _UP_Z)
    uu = uu / _norm(uu)
    vv = _cross(uu, ww)
    lo, hi = box
    light = np.array([0.6, 0.4, 0.8], _f32)
    light /= np.linalg.norm(light)
    return dict(ro=ro, uu=uu, vv=vv, ww=ww, center=((lo + hi) * _f32(0.5)).astype(_f32),
                scale=_f32(max(float(np.max(hi - lo)) / 2, 1e-9)), light=light,
                far=cam + _f32(4.0))


def _consts(cam: dict, relax: float, device) -> dict:
    like = torch.empty(0, device=device)
    c = {k: sdf.const(v, like) for k, v in cam.items()}
    c.update(ww18=sdf.const(_f32(1.8) * cam["ww"], like), relax=sdf.const(_f32(relax), like),
             march_eps=sdf.const(MARCH_EPS, like), hit_eps=sdf.const(HIT_EPS, like),
             tiny=sdf.const(_f32(1e-20), like), kh=sdf.const(NORMAL_K * NORMAL_H, like),
             base=sdf.const(BASE, like), sky=sdf.const(SKY, like))
    return c


def _rays(c, rw: int, rh: int, device):
    iy = torch.arange(rh, dtype=torch.float32, device=device)[:, None].expand(rh, rw)
    ix = torch.arange(rw, dtype=torch.float32, device=device)[None, :].expand(rh, rw)
    w, h = sdf.const(_f32(rw), ix), sdf.const(_f32(rh), ix)
    ux = sdf.div(2.0 * ix - w, h).reshape(-1)
    uy = sdf.div(-(2.0 * iy - h), h).reshape(-1)
    r = [(ux * c["uu"][k] + uy * c["vv"][k]) + c["ww18"][k] for k in range(3)]
    length = sdf.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
    return torch.stack([sdf.div(x, length) for x in r], -1)


def _scene(part, c, p, dtype):
    q = p * c["scale"] + c["center"]
    return sdf.div(part.distance(q.to(dtype)).to(torch.float32), c["scale"])


def _march_step(part, c, rd, t, dtype):
    d = _scene(part, c, c["ro"] + rd * t[:, None], dtype)
    hit = torch.abs(d) < c["march_eps"]
    moved = t + d * c["relax"]
    return torch.where(hit, t, moved), hit | (moved > c["far"])


def _shade(part, c, rd, t, dtype):
    pos = c["ro"] + rd * t[:, None]
    d = _scene(part, c, torch.cat([pos] + [pos + c["kh"][q] for q in range(4)]), dtype)
    d = d.reshape(5, -1)
    k = NORMAL_K.tolist()
    n = [((k[0][a] * d[1] + k[1][a] * d[2]) + k[2][a] * d[3]) + k[3][a] * d[4] for a in range(3)]
    length = sdf.sqrt(((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]) + c["tiny"])
    n = [sdf.div(x, length) for x in n]
    light = c["light"]
    dif = torch.clamp((n[0] * light[0] + n[1] * light[1]) + n[2] * light[2], 0.0, 1.0)
    lit = 0.25 * (0.5 + 0.5 * n[2]) + 0.8 * dif
    rn2 = 2.0 * ((rd[:, 0] * n[0] + rd[:, 1] * n[1]) + rd[:, 2] * n[2])
    r = [rd[:, a] - rn2 * n[a] for a in range(3)]
    spec = torch.clamp((r[0] * light[0] + r[1] * light[1]) + r[2] * light[2], 0.0, 1.0)
    for _ in range(4):  # spec ** 16
        spec = spec * spec
    hit = torch.abs(d[0]) < c["hit_eps"]
    col = torch.stack([torch.where(hit, c["base"][a] * lit + 0.15 * spec,
                                   c["sky"][a] - 0.4 * rd[:, 2]) for a in range(3)], -1)
    col = torch.clamp(col, 0.0, 1.0)
    if col.device.type == "cpu":  # torch's float32 CPU pow is not rounded once
        col = torch.pow(col.double(), float(GAMMA)).float()
    else:
        col = torch.pow(col, float(GAMMA))
    return (col * 255.0).to(torch.uint8)


def frame(part, cam: dict, width: int, height: int, steps: int, relax: float, aa: int,
          device, dtype=torch.float32, rays_per_call: int = 1 << 22):
    """((height, width, 3) u8 image, tree evaluations in all) of `part`
    under `cam`; the part evaluated on `dtype` points (bfloat16 for the
    control). Rays are marched `rays_per_call` at a time."""
    rw, rh = width * aa, height * aa
    c = _consts(cam, relax, device)
    rd_all = _rays(c, rw, rh, device)
    cols, evals = [], 0
    for lo in range(0, rw * rh, rays_per_call):
        rd = rd_all[lo:lo + rays_per_call]
        t = torch.zeros(len(rd), dtype=torch.float32, device=device)
        live = torch.arange(len(rd), device=device)
        for _ in range(steps):
            if not live.numel():
                break
            evals += live.numel()
            t_live, done = _march_step(part, c, rd[live], t[live], dtype)
            t[live] = t_live
            live = live[~done]
        cols.append(_shade(part, c, rd, t, dtype))
        evals += 5 * len(rd)
    img = torch.cat(cols).reshape(rh, rw, 3)
    if aa > 1:
        s = img.reshape(height, aa, width, aa, 3).to(torch.int32).sum(dim=(1, 3))
        img = torch.div(2 * s + aa * aa, 2 * aa * aa, rounding_mode="floor").to(torch.uint8)
    return img, evals


def relaxation(part) -> float:
    """0.6 for a part with a domain warp, a node whose class says
    `WARPS = True` (a helical sweep, a twist: not 1-Lipschitz, so full
    steps overshoot its thin features), else 0.8."""
    seen, stack = set(), [part]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if getattr(n, "WARPS", False):
            return 0.6
        for v in vars(n).values():
            if isinstance(v, (list, tuple)):
                stack += [x for x in v if hasattr(x, "distance")]
                stack += [x[0] for x in v if isinstance(x, tuple) and hasattr(x[0], "distance")]
            elif hasattr(v, "distance"):
                stack.append(v)
    return 0.8
