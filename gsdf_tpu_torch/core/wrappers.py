"""Node wrappers (gsdf_tpu/core/wrappers.py; reference glbuild.go:1080-1232).

`with_bounds` overrides a shape's bounding box (reference
OverloadShader3DBounds / OverloadShader2DBounds): used to tighten
conservative bounds or to clip the rendered region. The distance, and
the generated C, pass through to the child.
"""
from __future__ import annotations

from ..geometry.boxes import Box
from .node import Shader2D, Shader3D


class _BoundsOverride:
    PARAMS = ("bb_min", "bb_max")
    CHILDREN = ("s",)

    def __init__(self, s, bb: Box):
        self.s = s
        self.bb_min = bb.min
        self.bb_max = bb.max
        self._rebind_derived()

    def _rebind_derived(self):
        self.bb = Box(self.bb_min, self.bb_max)

    def distance(self, p):
        return self.s.distance(p)

    def emit_cuda(self, cg) -> str:
        args = ("px", "py", "pz")[: self.NDIM]
        return f"return {cg.call(self.s, *args)};"

    def bounds(self) -> Box:
        return self.bb


class BoundsOverride3(_BoundsOverride, Shader3D):
    pass


class BoundsOverride2(_BoundsOverride, Shader2D):
    pass


def with_bounds(s, bb: Box):
    """Return s with its bounding box replaced by bb."""
    if isinstance(s, Shader3D):
        return BoundsOverride3(s, bb)
    if isinstance(s, Shader2D):
        return BoundsOverride2(s, bb)
    raise TypeError(f"expected a shader, got {type(s)}")
