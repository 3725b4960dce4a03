"""TTF text -> 2D SDF (port of gsdf_tpu/forge/textsdf; reference
forge/textsdf). The font is read by the port's own TrueType reader
(`sfnt`), in the standard library."""
from .font import COUNTS, Font, FontConfig

__all__ = ["COUNTS", "Font", "FontConfig"]
