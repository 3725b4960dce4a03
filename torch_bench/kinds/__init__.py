"""The request kinds a traffic mix can name (`"request": "<kind>"`), one
file each: `kinds/<kind>.py` defines `Kind`, a `Request` that drives the
program through the entry a user calls.

A kind owns everything about its request: the warm-up of its shape, one
request from the generator's parameters, the latency a user feels, what
the check keeps of each answer and how it compares a sample of them with
the plain reference once the window has closed, the bound of the device
work its window needed, the release of the program's state before the
reference runs, and the control's answers. The harness and the control
call these methods and never ask which kind they hold, so a mix that
needs a new request adds a file here. `fault` plants a fault in the
answers (the CPU tests' proof that `correct` can come out false).
"""
from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def program_attr(dotted: str):
    mod, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


def load(kind: str):
    """The `Kind` class of `kinds/<kind>.py`."""
    if kind.startswith("_") or not os.path.exists(os.path.join(HERE, f"{kind}.py")):
        raise SystemExit(f"no request kind {kind!r} under torch_bench/kinds/")
    return importlib.import_module(f"{__name__}.{kind}").Kind


class Request:
    #: answers kept whole for the check
    sample_size = 2
    #: the span whose length is a request's latency; None: the whole request
    latency_span = None
    #: requests of a seed's sequence that the control's sample is drawn from
    control_requests = 64
    #: attributes that hold the program's state, dropped before the check
    program_state: tuple = ()

    def __init__(self, cell, part, device, fault=None):
        self.cell, self.part, self.device, self.fault = cell, part, device, fault
        self.config, self.mix = cell.config, cell.mix
        self.summaries: list = []
        self.work: dict = {}

    def warm(self, spans):
        raise NotImplementedError

    def issue(self, params, spans) -> dict:
        """One request; returns the answer the check may keep."""
        raise NotImplementedError

    def summary(self, answer):
        """What the check keeps of every answer (cheap)."""
        return None

    def mark(self):
        """Where the answers of a window begin (a retaken window rewinds to
        it)."""
        return len(self.summaries)

    def rewind(self, mark):
        del self.summaries[mark:]

    def count_work(self, mark):
        """Count, with the program still there, what the bound of the
        window's device work needs (after a traced window)."""

    def release(self):
        """Drop the program's state, so the reference runs on a free card."""
        self.part = None
        for name in self.program_state:
            setattr(self, name, None)

    def check(self, samples, ref_part, device, dtype=None) -> dict:
        """The compared numbers of `samples` against the reference."""
        raise NotImplementedError

    def bound_s(self, completed: int):
        """Seconds of the bound of the traced window's device work, or None
        where it is not known."""
        return None

    def control_sample(self, params, state: dict):
        """What the control's answer for the request `params` is made from;
        `state` carries what earlier requests of the sequence left."""
        return params

    def control_answer(self, sample, ref_part, device, dtype) -> dict:
        raise NotImplementedError

    def control_extra(self, kept, baked: bool) -> dict:
        """Numbers of the control made by the program itself (none here)."""
        return {}
