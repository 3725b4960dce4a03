"""Renderers and mesh output."""
from .dual_contour import DualContourLeastSquares, DualContourRenderer, minecraft_render
from .flat import FlatRenderer, render_flat
from .image import (
    bw_conversion,
    iq_debug_conversion,
    render_distance_field,
    render_image_2d,
    write_png,
)
from .pruned import PrunedRenderer, render_all
from .mesh_export import (
    write_obj,
    write_obj_file,
    write_obj_indexed,
    write_obj_indexed_file,
    write_ply,
    write_ply_file,
    write_ply_indexed,
    write_ply_indexed_file,
)
from .stl import read_binary_stl, write_binary_stl, write_binary_stl_indexed, write_stl_file

__all__ = [
    "DualContourLeastSquares",
    "DualContourRenderer",
    "FlatRenderer",
    "PrunedRenderer",
    "bw_conversion",
    "iq_debug_conversion",
    "minecraft_render",
    "read_binary_stl",
    "render_all",
    "render_distance_field",
    "render_flat",
    "render_image_2d",
    "write_binary_stl",
    "write_binary_stl_indexed",
    "write_obj",
    "write_obj_file",
    "write_obj_indexed",
    "write_obj_indexed_file",
    "write_ply",
    "write_ply_file",
    "write_ply_indexed",
    "write_ply_indexed_file",
    "write_png",
    "write_stl_file",
]
