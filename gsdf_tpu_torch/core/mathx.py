"""float32 math helpers shared by the port's SDF nodes (torch counterpart
of gsdf_tpu/core/mathx.py).

Every helper keeps the JAX package's expression and association so that
the plain torch evaluation agrees with it to the last ulp wherever the
operations are IEEE (add, mul, div, sqrt, min/max, floor):

- sign is 0 at 0, clamp/mix exactly as GLSL (reference gsdf.go:141-189);
- sqrt, sin and cos go through `_rounded`: torch's float32 CPU kernels
  are not correctly rounded (sqrt differs from the IEEE result on about
  0.7% of inputs, sin and cos on about 5%), so on the CPU they run in
  float64 and round once. The JAX package's CPU sqrt is IEEE and its sin
  and cos are within an ulp of the rounded ones: with this the bolt,
  flange and showerhead grids at resdiv 60 equal the JAX package's bit
  for bit, and the knurled cylinder's differ by at most 1.4e-6. torch's
  own atan2 keeps those grids bit-exact, the rounded one does not, so
  atan2 (and acos) stay torch's. On CUDA every one of them is torch's
  kernel, i.e. the CUDA math library's precise sqrtf, sinf, cosf, atan2f
  and acosf that the generated kernels call, so kernel and plain version
  agree bit for bit on the card;
- hypot is sqrt(x*x + y*y), never torch.hypot (a different rounding);
  length and dot are the same left-to-right sums over the components;
- division by a constant goes through a 0-dim tensor on the operand's
  device: PyTorch's CUDA division by a host scalar multiplies by the
  reciprocal, which is not the IEEE quotient.

The Mosaic workarounds of the JAX package (polynomial atan2/acos, the
fori_loop scan) have no counterpart here: torch.atan2/acos and plain
loops serve every device.

`cbrt` is the one function the port defines itself: torch has no cube
root, so the plain version and the generated C (`gsdf_cbrt`, codegen/
cuda.py) run the same bit-trick guess and Newton steps in IEEE float32,
and agree bit for bit on every device.
"""
from __future__ import annotations

import numpy as np
import torch

# reference gsdf.go:16-25
TRIBISECT = 0.8660254037844386467637231707529361834714026269051903140279
SQRT3 = 1.7320508075688772935274463415058723669428052538103806280558
SQRT2D2 = 0.7071067811865476
LARGENUM = 1e20
EPSTOL = 6e-7

_f32 = np.float32

#: cbrt's guess bits(x)/3 + CBRT_MAGIC is within about 3.5% (the constant
#: is (127 - 127/3 - 0.0331) * 2**23, FreeBSD s_cbrtf's B1); the error
#: squares each Newton step, so three reach float32's last ulp
CBRT_MAGIC = 709958130
CBRT_STEPS = 3


def lit(x) -> float:
    """A constant as the Python float of its float32 value: torch casts it
    back to exactly that float32 when it meets a float32 tensor."""
    return float(_f32(x))


def const(x, like: torch.Tensor) -> torch.Tensor:
    """float32 constant (scalar or array) on `like`'s device."""
    return torch.as_tensor(np.asarray(x, _f32), device=like.device)


def div(a, b) -> torch.Tensor:
    """IEEE float32 a / b on every device (see the module note); either
    side may be a host constant."""
    if not isinstance(b, torch.Tensor):
        b = const(b, a)
    elif not isinstance(a, torch.Tensor):
        a = const(a, b)
    return a / b


def clamp(v, lo, hi):
    """GLSL clamp, min(max(v, lo), hi)."""
    return torch.clamp(v, lo, hi)


def mix(x, y, a):
    """GLSL mix: x*(1-a) + y*a (reference mixf, gsdf.go:165)."""
    return x * (1 - a) + y * a


def sign(x):
    """sign with sign(0)=0, matching reference signf (gsdf.go:148)."""
    return torch.sign(x)


def _rounded(fn, *xs):
    """fn on the CPU in float64, rounded once to float32; on other devices
    torch's float32 kernel (on CUDA the CUDA math library's precise
    function, the one the generated kernels call)."""
    if xs[0].device.type == "cpu":
        return fn(*(x.double() for x in xs)).float()
    return fn(*xs)


def sqrt(x):
    return _rounded(torch.sqrt, x)


def sin(x):
    return _rounded(torch.sin, x)


def cos(x):
    return _rounded(torch.cos, x)


def hypot(x, y):
    return sqrt(x * x + y * y)


def dot(a, b):
    """Sum of a*b over the last axis, left to right."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def length(v):
    """Euclidean norm over the last axis."""
    return sqrt(dot(v, v))


def ndot(a, b):
    """negative dot: ax*bx - ay*by (reference gsdf.go:178)."""
    return a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]


def cross2(a, b):
    """2D cross product z-component."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


#: cos_acos_3's polynomial, highest power first (reference gsdf.go:186-189)
COS_ACOS_3_COEFFS = (-0.008972, 0.039071, 0.107074, 0.576975)


def cos_acos_3(x):
    """Polynomial approximation of cos(acos(x)/3) (reference gsdf.go:186-189)."""
    c0, c1, c2, c3 = (lit(c) for c in COS_ACOS_3_COEFFS)
    x = sqrt(0.5 + 0.5 * x)
    return x * (x * (x * (x * c0 + c1) - c2) + c3) + 0.5


def atan2(y, x):
    return torch.atan2(y, x)


def acos(x):
    return torch.acos(x)


def round_half_away(x):
    """Round half away from zero (Go math32.Round, cpu_evaluators.go:376);
    torch.round and C roundf differ from this expression's rounding."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def cbrt(x):
    """Cube root of float32 x >= 0, the same operations as gsdf_cbrt in
    the generated C: guess bits(x)/3 + magic, then Newton steps
    y - (y*y*y - x) / (3*y*y). 0 and inf map to themselves."""
    bits = x.view(torch.int32)
    y = (torch.div(bits, 3, rounding_mode="trunc") + CBRT_MAGIC).view(torch.float32)
    for _ in range(CBRT_STEPS):
        y = y - (y * y * y - x) / (3.0 * y * y)
    return torch.where((x == 0) | torch.isinf(x), x, y)
