"""High-level render pipeline (reference gsdfaux.RenderShader3D,
gsdfaux/gsdfaux.go:63-241; torch counterpart of
gsdf_tpu/pipeline/render.py): tree -> renderer -> STL, 2D tree -> PNG,
and a turntable of the raymarcher (`ui`), with stopwatch log lines in the
reference's `[dur] msg` format.

The shadertoy visual (`RenderConfig.visual_output`) waits for the port of
visual/shadertoy.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import BinaryIO, Callable, Optional, TextIO

from ..core.node import Shader3D
from ..kernels import default_device
from ..render.flat import FlatRenderer
from ..render.image import render_image_2d, write_png
from ..render.stl import write_binary_stl_indexed


@dataclasses.dataclass
class RenderConfig:
    """(reference gsdfaux.go:25-47)."""

    stl_output: Optional[BinaryIO] = None
    visual_output: Optional[TextIO] = None
    resolution: float = 0.0
    use_gpu: bool = True  # False renders on the CPU (plain torch)
    silent: bool = False
    #: accepted for API parity with the reference's BlockCachedSDF3 option;
    #: the fused device path evaluates each grid corner exactly once, so a
    #: voxel memo cache cannot reduce work and the flag is a no-op.
    enable_caching: bool = False
    device: object = None


def _stopwatch():
    start = time.monotonic()
    last = [start]

    def lap():
        now = time.monotonic()
        dt = now - last[0]
        last[0] = now
        return dt

    return lap


def _fmt_dur(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}µs"
    if seconds < 1:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds:.3f}s"


def render_shader3d(obj: Shader3D, cfg: RenderConfig) -> dict:
    """Render a 3D shape to STL through the compact-field main path.

    Returns a stats dict: triangles, evaluations, timings, and the indexed
    mesh (`verts`, `tri_idx`; callers gather a soup with verts[tri_idx]).
    """
    if cfg.resolution <= 0:
        raise ValueError("RenderConfig.resolution must be positive")
    if cfg.visual_output is not None:
        raise NotImplementedError(
            "RenderConfig.visual_output needs the shadertoy export, "
            "visual/shadertoy.py, which is not ported yet"
        )
    log: Callable[[str], None] = (lambda msg: None) if cfg.silent else print
    lap = _stopwatch()
    stats: dict = {}

    if cfg.device is not None:
        device = cfg.device
    else:
        device = default_device() if cfg.use_gpu else "cpu"

    renderer = FlatRenderer(obj, cfg.resolution, device=device)
    log(f"[{_fmt_dur(lap())}] renderer init (grid {renderer.nx}x{renderer.ny}x{renderer.nz})")

    verts, tri_idx = renderer.render_compact()
    dt_render = lap()
    stats["render_seconds"] = dt_render
    stats["triangles"] = len(tri_idx)
    stats["evaluations"] = renderer.evaluations()
    log(
        f"[{_fmt_dur(dt_render)}] evaluated SDF {renderer.evaluations()} times "
        f"and generated {len(tri_idx)} triangles at resolution {cfg.resolution:.6g}"
    )

    if cfg.stl_output is not None:
        n = write_binary_stl_indexed(cfg.stl_output, verts, tri_idx)
        dt_stl = lap()
        stats["stl_seconds"] = dt_stl
        stats["stl_bytes"] = n
        log(f"[{_fmt_dur(dt_stl)}] wrote {n} bytes STL")

    stats["verts"] = verts
    stats["tri_idx"] = tri_idx
    return stats


def render_png_file_2d(path, obj, width: int = 512, height: int = 512, device=None):
    """Render a 2D SDF to a PNG file (reference gsdfaux.RenderPNGFile,
    gsdfaux.go:267)."""
    img = render_image_2d(obj, width, height, device=device)
    write_png(path, img)
    return img


@dataclasses.dataclass
class UIConfig:
    """(reference gsdfaux.UIConfig, gsdfaux.go:49). `device` is the port's:
    where the frames render (None: the card), as RenderConfig's."""

    width: int = 800
    height: int = 600
    frames: int = 24
    pitch: float = 0.5
    gif_path: Optional[str] = None
    device: object = None


def ui(obj: Shader3D, cfg: UIConfig = UIConfig()):
    """Headless counterpart of the reference's interactive raymarch UI
    (gsdfaux.UI): renders an orbiting turntable of the part with the
    raymarcher on the card (K8) and optionally writes an animated GIF.
    Returns the list of (H,W,3) frames."""
    from ..visual.raymarch import turntable

    return turntable(
        obj,
        n_frames=cfg.frames,
        width=cfg.width,
        height=cfg.height,
        pitch=cfg.pitch,
        gif_path=cfg.gif_path,
        device=cfg.device,
    )
