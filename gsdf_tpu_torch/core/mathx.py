"""float32 math helpers shared by the port's SDF nodes (torch counterpart
of gsdf_tpu/core/mathx.py).

Every helper keeps the JAX package's expression and association so that
the plain torch evaluation agrees with it to the last ulp wherever the
operations are IEEE (add, mul, div, sqrt, min/max, floor):

- clamp/mix exactly as GLSL;
- hypot is sqrt(x*x + y*y), never torch.hypot (a different rounding);
- division by a constant goes through a 0-dim tensor on the operand's
  device: PyTorch's CUDA division by a host scalar multiplies by the
  reciprocal, which is not the IEEE quotient.

The Mosaic workarounds of the JAX package (polynomial atan2/acos, the
fori_loop scan) have no counterpart here: torch.atan2 and plain loops
serve every device.
"""
from __future__ import annotations

import numpy as np
import torch

# reference gsdf.go:16-25
LARGENUM = 1e20

_f32 = np.float32


def lit(x) -> float:
    """A constant as the Python float of its float32 value: torch casts it
    back to exactly that float32 when it meets a float32 tensor."""
    return float(_f32(x))


def const(x, like: torch.Tensor) -> torch.Tensor:
    """float32 constant (scalar or array) on `like`'s device."""
    return torch.as_tensor(np.asarray(x, _f32), device=like.device)


def div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE float32 a / b on every device (see the module note)."""
    if not isinstance(b, torch.Tensor):
        b = const(b, a)
    return a / b


def clamp(v, lo: float, hi: float):
    return torch.clamp(v, lo, hi)


def mix(x, y, a):
    """GLSL mix: x*(1-a) + y*a (reference mixf, gsdf.go:165)."""
    return x * (1 - a) + y * a


def hypot(x, y):
    return torch.sqrt(x * x + y * y)
