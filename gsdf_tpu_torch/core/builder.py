"""Builder error policy (torch-port counterpart of gsdf_tpu/core/builder.py).

A `Flags` bitmask decides whether invalid dimensions raise at once (the
default) or accumulate for `err()` (reference gsdf.go:27-106).
"""
from __future__ import annotations

import enum
from typing import List


class Flags(enum.IntFlag):
    NONE = 0
    #: don't raise on invalid shape dimensions; accumulate errors instead
    #: (reference FlagNoDimensionPanic, gsdf.go:33).
    NO_DIMENSION_PANIC = 1 << 0


class ShapeError(ValueError):
    """Raised for invalid shape dimensions when NO_DIMENSION_PANIC unset."""


class BuilderCore:
    """Error-policy core. Shape methods are added by mixin modules."""

    def __init__(self, flags: Flags = Flags.NONE):
        self._flags = flags
        self._accum_errs: List[ShapeError] = []

    def err(self) -> Exception | None:
        if not self._accum_errs:
            return None
        if len(self._accum_errs) == 1:
            return self._accum_errs[0]
        return ExceptionGroup("accumulated shape errors", list(self._accum_errs))

    def shape_error(self, msg: str) -> None:
        if not self._flags & Flags.NO_DIMENSION_PANIC:
            raise ShapeError(msg)
        self._accum_errs.append(ShapeError(msg))

    def nilsdf(self, msg: str) -> None:
        raise ValueError("nil SDF argument: " + msg)
