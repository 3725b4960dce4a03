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
same; the codegen names baked functions by it.

A node class lists in `CONT_PARAMS` (the JAX package's tuples) the
parameters that `rebind` may edit in place and that the parametric
kernels read from a kernel argument instead of a literal
(eval/parametric.py); every other parameter is structural. `struct_key`
is the hash of a subtree with its continuous values masked: the
parametric codegen names and shares functions by it.
"""
from __future__ import annotations

import hashlib
import math
from typing import Iterable, Tuple

import numpy as np

from ..geometry.boxes import Box

#: Shader.lower_bound's "unknown"
NO_BOUND = np.float32(-np.inf)


def finite(*values) -> bool:
    """True where every value (a scalar or an array) is a finite float32:
    what a node's bound and its nan_free need of the literals it emits."""
    return all(bool(np.all(np.isfinite(np.asarray(v, np.float32)))) for v in values)


def radial_at(steps, d) -> np.float32:
    """A radial bound's value (Shader.radial_bound) at the float32
    distance `d` from the z axis, by the C's float32 operations."""
    v = np.float32(d)
    for op, c in steps:
        v = v + np.float32(c) if op == "+" else v - np.float32(c)
    return np.float32(v)


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
    #: names of the continuous parameters: float32 values that `rebind`
    #: may edit and that no emitter or Python branch decides by.
    CONT_PARAMS: Tuple[str, ...] = ()

    _tree_hash_cache: bytes | None = None
    _struct_key_cache: bytes | None = None

    def children(self) -> Tuple["Shader", ...]:
        return tuple(getattr(self, name) for name in self.CHILDREN)

    def _hash_own(self, h, masked: bool = False) -> None:
        """Feed `h` this node's type and parameters (no children): each
        value's bytes, or with `masked` the shape alone of a continuous
        parameter."""
        h.update(type(self).__qualname__.encode())
        for name in self.PARAMS:
            h.update(name.encode())
            v = getattr(self, name)
            if masked and name in self.CONT_PARAMS:
                h.update(str(tuple(np.shape(v))).encode())
            else:
                h.update(_param_bytes(v))

    def tree_hash(self) -> bytes:
        """Structural hash: node type + params + child hashes."""
        if self._tree_hash_cache is None:
            h = hashlib.blake2b(digest_size=16)
            self._hash_own(h)
            for c in self.children():
                h.update(c.tree_hash())
            self._tree_hash_cache = h.digest()
        return self._tree_hash_cache

    def struct_key(self) -> bytes:
        """Hash of the subtree's structure: tree_hash's scheme with every
        continuous parameter's value replaced by its shape. `rebind`
        cannot change it, so it is cached for the node's life."""
        if self._struct_key_cache is None:
            h = hashlib.blake2b(digest_size=16)
            self._hash_own(h, masked=True)
            children = self.children()
            h.update(len(children).to_bytes(4, "little"))
            for c in children:
                h.update(c.struct_key())
            self._struct_key_cache = h.digest()
        return self._struct_key_cache

    def param_children(self) -> Tuple["Shader", ...]:
        """The children in the order in which the parametric kernel's
        vector holds their parameter slices (codegen/params.py); a node
        that loops one function over several children (OpUnion) puts
        those side by side."""
        return self.children()

    def visit_bfs(self) -> Iterable["Shader"]:
        """All nodes of the tree in BFS order (root first)."""
        queue = [self]
        while queue:
            n = queue.pop(0)
            yield n
            queue.extend(n.children())

    def visit_dfs(self) -> Iterable["Shader"]:
        """All nodes of the tree in DFS pre-order (root first; reference
        forEachNodeDFS, glbuild/glbuild.go:783)."""
        stack = [self]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(list(n.children())))

    def node_count(self) -> int:
        return sum(1 for _ in self.visit_bfs())

    def rebind(self, edits: dict) -> "Shader":
        """In-place edit of continuous parameters, the parametric-editing
        API (gsdf_tpu/core/node.py:94-144; pairs with FlatRenderer's
        parametric=True renders: same structure, no new kernel library).

        edits: {node: {param_name: new_value}}; each node is an object in
        THIS tree and each name is in its CONT_PARAMS. Structural
        parameters are rejected: rebuild the tree to change those. Values
        are cast to float32 and array shapes must match. A node with a
        `_rebind_derived()` hook (a transform's inverse) has it called
        after its edits. Every cached tree hash of the tree is cleared,
        so a baked render of the edited tree builds a fresh library and
        never runs a stale one. Returns self."""
        in_tree = {id(n) for n in self.visit_bfs()}
        for node, kv in edits.items():
            if id(node) not in in_tree:
                raise ValueError(f"{type(node).__name__} node is not in this tree")
            cont = set(node.CONT_PARAMS)
            for name, val in kv.items():
                if name not in node.PARAMS:
                    raise AttributeError(
                        f"{type(node).__name__} has no parameter {name!r}"
                    )
                if name not in cont:
                    raise ValueError(
                        f"{type(node).__name__}.{name} is structural (baked "
                        "into the trace); rebuild the tree to change it"
                    )
                old = np.asarray(getattr(node, name), np.float32)
                new = np.asarray(val, np.float32)
                if new.shape != old.shape:
                    raise ValueError(
                        f"{type(node).__name__}.{name}: shape {new.shape} "
                        f"!= existing {old.shape}"
                    )
                object.__setattr__(
                    node, name, new if new.shape else np.float32(val)
                )
            derive = getattr(node, "_rebind_derived", None)
            if derive is not None:
                derive()
        for n in self.visit_bfs():
            object.__setattr__(n, "_tree_hash_cache", None)
        return self

    def lower_bound(self) -> np.float32:
        """A float32 that this node's baked function (emit_cuda) never
        returns less than at a point none of whose coordinates is NaN (a
        NaN result exempt); -inf where unknown. A class states a bound
        only with its derivation from its own emitted float32 operations
        beside it: IEEE rounding is monotone, so x >= x0 and y >= y0 give
        fl(x + y) >= fl(x0 + y0), and likewise for a subtraction of a
        constant, sqrtf, fabsf, fmaxf and fminf of non-NaN values. The
        codegen's Difference skips its subtrahend where the minuend
        exceeds minus this (codegen/cuda.py, Codegen.subtrahend)."""
        return NO_BOUND

    def nan_free(self) -> bool:
        """True where this node's baked function provably returns no NaN at
        a point none of whose coordinates is NaN: what a bound through
        fmaxf needs (fmaxf(NaN, y) is y). False where unknown."""
        return False

    def emit_point_bound(self, cg) -> str | None:
        """The body of a C function of this node's own coordinates (the
        arguments of its baked function) that bounds the baked function
        from below point by point, or None where the class states none.
        The contract, at every point, NaN coordinates included: where the
        bound's value is no NaN, the node's value is no NaN and no less
        than it. A class states one only with its derivation from its own
        emitted float32 operations beside it (lower_bound's rules); a
        transform's bound is its child's at the very coordinates it passes
        the child, so the child's contract covers them whatever they are.
        `cg.point_bound(child)` names a child's bound function (None where
        it has none). The codegen's OpUnion skips a member where the
        members run before it already undercut its point bound
        (codegen/cuda.py, the module note). By default the class's radial
        bound (radial_bound), where it states one."""
        steps = self.radial_bound()
        if steps is None:
            return None
        return f"return sqrtf(px * px + py * py){''.join(f' {op} {cg.lit(c)}' for op, c in steps)};"

    def radial_bound(self) -> tuple | None:
        """A point bound (emit_point_bound's contract) stated as float32
        steps on the point's distance from the z axis, d = sqrtf(px * px +
        py * py): pairs (op, c), op "+" or "-" and c a float32 constant,
        applied left to right; None where the class states none. From it
        the default emit_point_bound writes the C and axis_reach reads how
        far from the axis the bound exceeds a threshold."""
        return None

    def axis_reach(self, t):
        """A float32 distance from the z axis at and beyond which the radial
        bound (radial_bound) exceeds the float32 `t`, at any z; None where
        the class states no radial bound or no finite reach exists. The
        bound is a chain of float32 additions of constants to d, each
        monotone (rounding is), so it exceeds t wherever d is no less than a
        value where it does. The search starts where it exceeds t in real
        arithmetic and steps up an ulp at a time. The codegen's bin table of
        a translate-group loop lists a cell's members by it
        (codegen/cuda.py, `bin_table`)."""
        steps = self.radial_bound()
        if steps is None or not finite(t, *(c for _, c in steps)):
            return None
        shift = math.fsum(float(c) if op == "+" else -float(c) for op, c in steps)
        reach = np.float32(max(np.float64(t) - shift, 0.0))
        for _ in range(64):
            if not np.isfinite(reach):
                return None
            if radial_at(steps, reach) > t:
                return reach
            reach = np.nextafter(reach, np.float32(np.inf))
        return None

    def emit_below(self, cg, t_max) -> str | None:
        """The body of this node's threshold form: a C function of its own
        coordinates and a float `t` (`<function>_below`), or None where the
        class states none. The contract, at every point and every t: where
        the node's baked value v is <= t, or t is NaN, it returns v bit for
        bit; elsewhere a value > t. The form may take a faster path where
        t <= t_max (a float32) and no coordinate is NaN. `cg.below(child,
        t_max)` names a child's form (None where it has none). A Difference
        calls its subtrahend's form with t = -a, its minuend's value, and
        t_max minus the minuend's lower bound (codegen/cuda.py, the module
        note)."""
        return None

    def emit_cuda(self, cg) -> str:
        """CUDA C body of this node's distance function. The arguments are
        `px, py, pz` (3D) or `px, py` (2D), after `const float* P` in
        parametric mode; `cg` (codegen.cuda.Codegen) names child functions,
        float literals, parameters and constant arrays."""
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
