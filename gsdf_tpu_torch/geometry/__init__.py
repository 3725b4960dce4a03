"""Host-side geometry: boxes, transforms, polygon building, splines."""
from .boxes import (
    Box,
    box2,
    box3,
    centered_box2,
    centered_box3,
    mul_box3,
    rotation_mat2,
    rotation_mat4,
    translation_mat4,
)

__all__ = [
    "Box",
    "box2",
    "box3",
    "centered_box2",
    "centered_box3",
    "mul_box3",
    "rotation_mat2",
    "rotation_mat4",
    "translation_mat4",
]
