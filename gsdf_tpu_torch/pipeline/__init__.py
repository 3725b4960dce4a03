"""High-level render pipeline helpers (gsdfaux equivalent)."""
from .render import RenderConfig, render_png_file_2d, render_shader3d

__all__ = [
    "RenderConfig",
    "render_png_file_2d",
    "render_shader3d",
]
