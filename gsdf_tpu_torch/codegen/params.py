"""The parametric kernels' parameter vector: a tree's continuous
parameters (each node class's `CONT_PARAMS`) as one float32 vector, which
the parametric source (`codegen.cuda.tree_source(tree, parametric=True)`)
reads from a kernel argument, and the key of the libraries built from that
source.

`param_spec`, `pack_params` and `structural_hash` are the JAX package's,
value for value and byte for byte (the tests hold them equal). What the
kernel reads is a second layout of the same numbers, `kernel_params`:
depth first, every occurrence of a node on its own, an OpUnion's looped
members side by side (`Shader.param_children`), because a generated
function reads its subtree's parameters as one contiguous slice. The
packed vector is gathered into it by `kernel_index`, built once per tree.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

from ..core.node import Shader

_f32 = np.float32


def param_spec(tree: Shader) -> List[Tuple[Shader, str, tuple]]:
    """(node, attr, shape) for every continuous parameter, BFS order. A
    node object that several parents share contributes its parameters
    ONCE."""
    spec = []
    seen = set()
    for node in tree.visit_bfs():
        if id(node) in seen:
            continue
        seen.add(id(node))
        for name in node.CONT_PARAMS:
            spec.append((node, name, tuple(np.shape(getattr(node, name)))))
    return spec


def _pack(spec) -> np.ndarray:
    parts = [np.asarray(getattr(node, name), _f32).reshape(-1) for node, name, _ in spec]
    if not parts:
        return np.zeros(1, _f32)
    return np.concatenate(parts)


def pack_params(tree: Shader) -> np.ndarray:
    """The tree's current continuous parameters as one float32 vector
    (`zeros(1)` for a tree that has none)."""
    return _pack(param_spec(tree))


def structural_hash(tree: Shader) -> bytes:
    """Like tree_hash but with continuous parameter VALUES masked (shapes
    kept): the key of the parametric kernel libraries. `rebind` cannot
    change it, so it is kept on the tree it was computed for."""
    cached = tree.__dict__.get("_structural_hash_cache")
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)

    def visit(n: Shader):
        n._hash_own(h, masked=True)
        for c in n.children():
            visit(c)

    visit(tree)
    digest = h.digest()
    object.__setattr__(tree, "_structural_hash_cache", digest)
    return digest


def kernel_index(tree: Shader) -> np.ndarray:
    """int64 index that gathers `pack_params(tree)` into the layout the
    parametric kernels read (codegen/cuda.py): node by node depth first in
    `param_children()` order, a node's own CONT_PARAMS first, and a node
    object that several parents share once per occurrence."""
    where = {}
    k = 0
    for node, name, shape in param_spec(tree):
        n = int(np.prod(shape)) if shape else 1
        where[id(node), name] = (k, n)
        k += n
    index: list = []

    def visit(node: Shader):
        for name in node.CONT_PARAMS:
            k0, n = where[id(node), name]
            index.extend(range(k0, k0 + n))
        for c in node.param_children():
            visit(c)

    visit(tree)
    return np.asarray(index if index else [0], np.int64)


def _layout(tree: Shader):
    """(param_spec, kernel_index, length of pack_params) of `tree`, made
    once and kept on it: `rebind` edits values, never the structure or
    which nodes are shared."""
    cached = tree.__dict__.get("_param_layout_cache")
    if cached is None:
        spec = param_spec(tree)
        cached = (spec, kernel_index(tree), int(_pack(spec).size))
        object.__setattr__(tree, "_param_layout_cache", cached)
    return cached


def kernel_params(tree: Shader) -> np.ndarray:
    """The tree's current continuous parameters in the parametric kernels'
    layout: float32, GSDF_NPARAMS long."""
    spec, index, _ = _layout(tree)
    return _pack(spec)[index]
