"""Carry a part built with the JAX package over to the port.

`from_reference_tree(node)` rebuilds a port tree from a gsdf_tpu tree
without importing gsdf_tpu: it is duck-typed on the reference's node
contract (`children()`, `PARAMS`, `type(node).__qualname__`). Class names
and PARAMS are the same in both packages, so the rebuilt tree has the
reference's tree_hash and renders the same part.
"""
from __future__ import annotations

import numpy as np

from .core.node import Shader
from .core.ops3 import Difference, Intersection, OpUnion, Scale, SmoothUnion, Translate
from .core.primitives2 import Polygon2D
from .core.primitives3 import Cylinder
from .forge.threads.core import ScrewNode

#: node types of the ported slice, by class qualname
NODE_TYPES = {
    cls.__qualname__: cls
    for cls in (
        Cylinder, Translate, Scale, Difference, Intersection, SmoothUnion,
        OpUnion, Polygon2D, ScrewNode,
    )
}


def _param(v):
    """A reference parameter as float32: a numpy scalar for 0-d values
    (hashed as such), an array otherwise."""
    a = np.asarray(v, np.float32)
    return a if a.ndim else np.float32(a)


def from_reference_tree(node) -> Shader:
    """Port tree equal to the reference tree `node` (same structure, same
    float32 parameters). Raises NotImplementedError on a node type the
    port does not have yet."""
    name = type(node).__qualname__
    cls = NODE_TYPES.get(name)
    if cls is None:
        raise NotImplementedError(f"node type {name} is not ported yet")
    children = [from_reference_tree(c) for c in node.children()]
    out = cls.__new__(cls)
    for p in cls.PARAMS:
        setattr(out, p, _param(getattr(node, p)))
    if cls is OpUnion:
        out.joined = tuple(children)
    else:
        if len(children) != len(cls.CHILDREN):
            raise ValueError(f"{name}: {len(children)} children, expected {len(cls.CHILDREN)}")
        for attr, child in zip(cls.CHILDREN, children):
            setattr(out, attr, child)
    return out
