"""Core SDF tree of the port: Builder, node contracts and the slice's
node types."""
from .builder import BuilderCore, Flags, ShapeError
from .node import Shader, Shader2D, Shader3D
from .ops3 import BuilderOps3
from .primitives2 import BuilderPrimitives2
from .primitives3 import BuilderPrimitives3


class Builder(BuilderCore, BuilderPrimitives3, BuilderPrimitives2, BuilderOps3):
    """Shape factory with the JAX package's method names and validation
    rules, limited to the constructors the ported slice needs."""


__all__ = ["Builder", "Flags", "ShapeError", "Shader", "Shader2D", "Shader3D"]
