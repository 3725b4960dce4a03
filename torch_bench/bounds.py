"""The least time the card could take for a request's work, against the
published peaks of one NVIDIA H100 SXM (data sheet; dense, no sparsity):

    bound = max(ops / FP32_PEAK, bytes / HBM_PEAK)

summed over the kernels a request needs. The work is what the inputs need,
however the program does it:

- a tree evaluated at a point costs the part's operations per point, which
  each configuration states as data (`ops_per_point`) and a CPU test
  recounts with `OpCounter`;
- a kernel that moves data costs each input byte read once and each output
  byte written once (`kernel_bytes`);
- a raymarched frame costs its tree evaluations times the operations per
  point, plus each march step's and each ray's own arithmetic
  (`raymarch_ops`);
- where the program's code skips what cannot change a point's distance (a
  short-circuit site that skips a function, a loop that walks only the
  members near the point), the work is what its lanes ran: the skipped
  functions' operations come off (`work_run`), as the program counts the
  skips; its own bound and table arithmetic counts nothing.

A share of the bound above 100% means the work is counted too high or the
time leaves part of the work out; nothing here clips it.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: H100 SXM float32 outside the tensor cores (a fused multiply-add counts 2)
FP32_PEAK = 67e12
#: H100 SXM HBM3
HBM_PEAK = 3.35e12

#: elementwise aten ops counted as one operation per output element
ELEMENTWISE = frozenset(
    """add sub rsub mul div true_divide neg abs sign sgn sqrt rsqrt reciprocal
    atan2 atan asin acos sin cos tan exp log pow floor ceil round trunc frac
    remainder fmod minimum maximum fmin fmax clamp clamp_min clamp_max where
    lt le gt ge eq ne isinf isnan logical_and logical_or logical_not""".split()
)
#: reductions, counted as the elements they fold away
REDUCTIONS = frozenset("sum amax amin max min prod".split())


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class OpCounter(TorchDispatchMode):
    """Counts the elementwise floating-point operations run inside it: each
    arithmetic aten op whose inputs or output are floating point adds its
    output's elements (a reduction: the elements it folds away). Casts,
    views, indexing and fills count nothing."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ELEMENTWISE or name in REDUCTIONS:
            flat = list(args) + list((kwargs or {}).values())
            res = out[0] if isinstance(out, tuple) else out
            binary = len(args) > 1 and isinstance(args[1], torch.Tensor)
            if isinstance(res, torch.Tensor) and (_is_float(res) or any(map(_is_float, flat))):
                if name in ELEMENTWISE or binary:
                    self.ops += res.numel()
                else:
                    self.ops += args[0].numel() - res.numel()
        return out


def count_ops(fn, *args) -> int:
    with OpCounter() as counter:
        fn(*args)
    return counter.ops


def per_item(fn, n: int = 256) -> int:
    """fn(2n)'s operations less fn(n)'s, over n: the cost of one more item,
    with work on constants dropped out. Raises unless it is linear."""
    per, rest = divmod(count_ops(fn, 2 * n) - count_ops(fn, n), n)
    if rest:
        raise RuntimeError(f"operation count not linear in items: {per} rest {rest}")
    return per


def ops_per_point(part, box, n: int = 256, seed: int = 0) -> int:
    """The part's floating-point operations per evaluated point, on seeded
    points in `box`, on the CPU."""
    lo = torch.as_tensor(box[0], dtype=torch.float32)
    hi = torch.as_tensor(box[1], dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    pts = lo + (hi - lo) * torch.rand((2 * n, 3), generator=g)
    return per_item(lambda m: part.distance(pts[:m].contiguous()), n)


def kernel_bytes(name: str, *, corners=0, cubes=0, active=0, n_t=0, pixels=0,
                 n_params=0) -> int:
    """Bytes a kernel must move: each input read once, each output written
    once.

    - classified_grid (eval + classify): writes 4 B per corner and 1 B per
      cube; the parametric form also reads 4 B per parameter;
    - compact_active: reads 1 B per cube, writes 4 B per active cube, 16 B
      per 256 active cubes (two block offsets) and 24 B of counts;
    - compact_emit: reads per active cube its id, case byte and 4
      distances, the block offsets; writes 1 B per active cube and 4 B per
      crossing edge (t);
    - raymarch: writes 3 B per output pixel (supersamples are scratch); the
      parametric form also reads 4 B per parameter.
    """
    offsets = 8 * -(-active // 256)
    per = {
        "classified_grid": 4 * corners + cubes + 4 * n_params,
        "compact_active": cubes + 4 * active + 2 * offsets + 24,
        "compact_emit": (4 + 1 + 16 + 1) * active + offsets + 4 * n_t,
        "raymarch": 3 * pixels + 4 * n_params,
    }
    return int(per[name])


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_PEAK, nbytes / HBM_PEAK)


def mesh_bound_s(corners: int, cubes: int, active: float, n_t: float, ops_pp: int,
                 n_params: int = 0) -> float:
    """Seconds of one compact render's device work: the tree at every corner
    and the classification, the compaction, the emit of case bytes and t."""
    return (bound_s(corners * ops_pp, kernel_bytes("classified_grid", corners=corners,
                                                   cubes=cubes, n_params=n_params))
            + bound_s(0, kernel_bytes("compact_active", cubes=cubes, active=int(active)))
            + bound_s(0, kernel_bytes("compact_emit", active=int(active), n_t=int(n_t))))


def raymarch_ops(evaluations: int, rays: int, ops_pp: int, step_ops: int,
                 ray_ops: int) -> int:
    """A frame's operations: the tree at every evaluation, each march step's
    own arithmetic (evaluations less the 5 of each ray's shading) and each
    ray's direction and shading."""
    return int(evaluations * ops_pp + (evaluations - 5 * rays) * step_ops + rays * ray_ops)


def skipped_function(counts: dict) -> str:
    """The function a short-circuit count (an entry of the program's
    `ray_kernels.SHORT_CIRCUITS`) skips: a Difference's subtrahend, a union
    member, or a loop's member."""
    return counts.get("subtrahend") or counts.get("member") or counts["loop"]


def skipped_ops(counts: dict, function_ops: dict) -> int:
    """The operations that the lanes behind `counts` ({name: the program's
    SHORT_CIRCUITS entry}) did not run: at each site its lane skips times
    its skipped function's operations a point, at each loop the members its
    lane entries did not walk times its member's (`function_ops`: a
    function's name -> its operations a point)."""
    out = 0
    for name, c in counts.items():
        n = c["entries"] * c["members"] - c["walked"] if "loop" in c else c["lane_skips"]
        if n < 0:
            raise ValueError(f"{name}: {n} skips")
        out += n * function_ops[skipped_function(c)]
    return int(out)


def work_run(ops: int, counts: dict, function_ops: dict) -> int:
    """`ops`, counted at the part's full operations a point, less what the
    lanes skipped (`skipped_ops`). Raises where the skips exceed what was
    counted: the counts are then not of these evaluations."""
    skipped = skipped_ops(counts, function_ops)
    if not 0 <= skipped <= ops:
        raise ValueError(f"{skipped} skipped operations of {ops} counted")
    return int(ops) - skipped
