"""Carry a part built with the JAX package over to the port.

`from_reference_tree(node)` rebuilds a port tree from a gsdf_tpu tree
without importing gsdf_tpu: it is duck-typed on the reference's node
contract (`children()`, `PARAMS`, `type(node).__qualname__`). Class names
and PARAMS are the same in both packages, and each parameter keeps the
type the JAX package hashes it by (float32 scalars and arrays, ints,
bools), so the rebuilt tree has the reference's tree_hash and renders the
same part. A node object that several parents share is converted once, so
the rebuilt tree shares it the same way and `param_spec`, `pack_params`
and `structural_hash` (codegen/params.py) equal the reference's too.
"""
from __future__ import annotations

import numpy as np

from .core import ops2, ops3, primitives2, primitives3, wrappers
from .core.node import Shader
from .forge.threads.core import ScrewNode

#: every node type of the JAX package's Builder, by class qualname
NODE_TYPES = {
    cls.__qualname__: cls
    for mod in (primitives3, primitives2, ops3, ops2, wrappers)
    for cls in vars(mod).values()
    if isinstance(cls, type) and issubclass(cls, Shader) and cls.__module__ == mod.__name__
    and not cls.__name__.startswith("_")
}
NODE_TYPES[ScrewNode.__qualname__] = ScrewNode

#: nodes whose children are a variable-length tuple
_JOINED = (ops3.OpUnion, ops2.OpUnion2D)


def _param(v):
    """A reference parameter as the port holds it: ints and bools as they
    are, float arrays as float32 arrays, float scalars as np.float32."""
    if isinstance(v, (bool, int, np.integer, np.bool_)):
        return v
    a = np.asarray(v, np.float32)
    return a if a.ndim else np.float32(a)


def from_reference_tree(node, _memo: dict | None = None) -> Shader:
    """Port tree equal to the reference tree `node` (same structure, same
    parameters, the same node objects shared). Raises NotImplementedError
    on a node type the port does not have."""
    memo = {} if _memo is None else _memo
    if id(node) in memo:
        return memo[id(node)]
    name = type(node).__qualname__
    cls = NODE_TYPES.get(name)
    if cls is None:
        raise NotImplementedError(f"node type {name} is not ported")
    children = [from_reference_tree(c, memo) for c in node.children()]
    out = cls.__new__(cls)
    for p in cls.PARAMS:
        setattr(out, p, _param(getattr(node, p)))
    if issubclass(cls, _JOINED):
        out.joined = tuple(children)
    else:
        if len(children) != len(cls.CHILDREN):
            raise ValueError(f"{name}: {len(children)} children, expected {len(cls.CHILDREN)}")
        for attr, child in zip(cls.CHILDREN, children):
            setattr(out, attr, child)
    # derived attributes (Transform/Rotation2D t_inv, BoundsOverride bb)
    derive = getattr(out, "_rebind_derived", None)
    if derive is not None:
        derive()
    memo[id(node)] = out
    return out
