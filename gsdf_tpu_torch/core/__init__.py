"""Core SDF tree of the port: Builder, node contracts and every node type
of the JAX package's Builder."""
from .builder import BuilderCore, Flags, ShapeError
from .node import Shader, Shader2D, Shader3D
from .ops2 import BuilderOps2
from .ops3 import BuilderOps3
from .primitives2 import BuilderPrimitives2
from .primitives3 import BuilderPrimitives3
from .wrappers import with_bounds


class Builder(BuilderCore, BuilderPrimitives3, BuilderPrimitives2, BuilderOps3, BuilderOps2):
    """Shape factory with the JAX package's method names and validation
    rules."""


__all__ = [
    "Builder", "Flags", "ShapeError", "Shader", "Shader2D", "Shader3D", "with_bounds",
]
