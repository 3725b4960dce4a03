"""SDF tree node contracts (torch counterpart of gsdf_tpu/core/node.py).

A node is a plain Python object with two ways to evaluate it:

- `distance(p)`: plain torch over batched points, on whatever device `p`
  lives on. This is the port's CPU oracle and every kernel's plain
  version.
- `emit_cuda(cg)`: the CUDA C body of the node's scalar distance function
  for the per-tree codegen (gsdf_tpu_torch/codegen/cuda.py), the
  counterpart of the reference's GLSL emitters (glbuild/glbuild.go:25-90).

`tree_hash` is the JAX package's scheme byte for byte (type qualname +
PARAMS + child hashes), so a part built through either Builder hashes the
same; the codegen names functions by it.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Tuple

import numpy as np

from ..geometry.boxes import Box


def _param_bytes(v) -> bytes:
    if isinstance(v, np.ndarray):
        return v.astype(np.float32, copy=False).tobytes() + str(v.shape).encode()
    if isinstance(v, (float, np.floating)):
        return np.float32(v).tobytes()
    if isinstance(v, (int, np.integer, bool)):
        return int(v).to_bytes(8, "little", signed=True)
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, (tuple, list)):
        out = b"("
        for x in v:
            out += _param_bytes(x) + b","
        return out + b")"
    raise TypeError(f"unhashable SDF parameter type {type(v)}")


class Shader:
    """Base for all SDF nodes (2D and 3D)."""

    #: names of attributes that are parameters (float32 scalars or numpy
    #: float32 arrays) contributing to structural identity.
    PARAMS: Tuple[str, ...] = ()
    #: names of attributes holding child nodes.
    CHILDREN: Tuple[str, ...] = ()

    _tree_hash_cache: bytes | None = None

    def children(self) -> Tuple["Shader", ...]:
        return tuple(getattr(self, name) for name in self.CHILDREN)

    def tree_hash(self) -> bytes:
        """Structural hash: node type + params + child hashes."""
        if self._tree_hash_cache is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(type(self).__qualname__.encode())
            for name in self.PARAMS:
                h.update(name.encode())
                h.update(_param_bytes(getattr(self, name)))
            for c in self.children():
                h.update(c.tree_hash())
            self._tree_hash_cache = h.digest()
        return self._tree_hash_cache

    def visit_bfs(self) -> Iterable["Shader"]:
        """All nodes of the tree in BFS order (root first)."""
        queue = [self]
        while queue:
            n = queue.pop(0)
            yield n
            queue.extend(n.children())

    def node_count(self) -> int:
        return sum(1 for _ in self.visit_bfs())

    def emit_cuda(self, cg) -> str:
        """CUDA C body of this node's distance function. The arguments are
        `px, py, pz` (3D) or `px, py` (2D); `cg` (codegen.cuda.Codegen)
        names child functions, float literals and constant arrays."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA emitter in this port"
        )


class Shader3D(Shader):
    """A 3D signed-distance node: distance maps (..., 3) -> (...,) f32."""

    NDIM = 3

    def distance(self, p):  # pragma: no cover - interface
        raise NotImplementedError

    def bounds(self) -> Box:  # pragma: no cover - interface
        raise NotImplementedError


class Shader2D(Shader):
    """A 2D signed-distance node: distance maps (..., 2) -> (...,) f32."""

    NDIM = 2

    def distance(self, p):  # pragma: no cover - interface
        raise NotImplementedError

    def bounds(self) -> Box:  # pragma: no cover - interface
        raise NotImplementedError
