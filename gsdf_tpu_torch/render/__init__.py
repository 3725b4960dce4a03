"""Renderers and mesh output."""
from .flat import FlatRenderer, render_flat
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
    "FlatRenderer",
    "read_binary_stl",
    "render_flat",
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
    "write_stl_file",
]
