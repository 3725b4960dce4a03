"""High-level render pipeline helpers (gsdfaux equivalent)."""
from .interactive import InteractiveViewer, interactive_view
from .render import RenderConfig, UIConfig, render_png_file_2d, render_shader3d, ui

__all__ = [
    "InteractiveViewer",
    "RenderConfig",
    "UIConfig",
    "interactive_view",
    "render_png_file_2d",
    "render_shader3d",
    "ui",
]
