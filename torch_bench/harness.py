"""One run of one cell: build the part, warm the cell's request shape,
issue requests in a closed loop (one client that waits for each answer)
for the window, then check a seeded sample of the answers against the
plain reference and reduce the metrics.

`execute` is device-agnostic: the command line (`run.py`) insists on the
card, the CPU tests drive the same code on the CPU at small sizes.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from . import generator, kinds, spec
from . import trace as tr

#: traced windows retaken when the profiler lost device events
TRACE_RETRIES = 2


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class Run:
    """What one run measured: the metric readers read it."""

    def __init__(self, cell, seed, seconds, traced):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.setup_s = 0.0
        self.window_s = 0.0
        self.attempted = self.completed = self.failed = 0
        self.latencies: list = []
        self.spans = tr.Spans(ranges=traced)
        self.trace = None
        self.device_bound_s = None  # seconds of the bound of the window's device work
        self.phases: dict = {}


class Sampler:
    """A seeded uniform sample of k answers from a stream (reservoir)."""

    def __init__(self, k, seed):
        self.k, self.rng, self.seen, self.kept = k, np.random.default_rng([seed, 1]), 0, []

    def offer(self, answer):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(answer)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = answer


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(run, req, gen, sampler, device):
    """Issue requests until `seconds` have passed; the window ends with the
    last answer."""
    start = end = time.perf_counter()
    while end - start < run.seconds:
        params = next(gen)
        t0 = time.perf_counter()
        run.attempted += 1
        try:
            answer = req.issue(params, run.spans)
        except Exception:  # a request that fails counts as failed, the loop goes on
            if not run.failed:
                log(traceback.format_exc())
            run.failed += 1
            answer = None
        end = time.perf_counter()
        if answer is not None:
            run.completed += 1
            run.latencies.append(run.spans.last[req.latency_span] if req.latency_span
                                 else end - t0)
            req.summaries.append(req.summary(answer))
            sampler.offer(answer)
    _sync(device)
    run.window_s = time.perf_counter() - start


def _traced_window(run, req, gen, sampler, device, launches):
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(TRACE_RETRIES + 1):
        run.spans.clear()
        before = sum(launches.values())
        mark = req.mark()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tr.WINDOW):
                _window(run, req, gen, sampler, device)
        run.trace = tr.reduce(tr.events_of(prof), sum(launches.values()) - before)
        if not run.trace.lost:
            break
        log(f"trace {attempt}: the profiler lost device events ({run.trace.kernels} kernels, "
            f"{run.trace.unmatched} of {run.trace.host_launches} launch calls without their "
            f"kernel, {sum(launches.values()) - before} wrapper launches); the window is taken "
            "again")
        run.attempted = run.completed = run.failed = 0
        run.latencies.clear()
        req.rewind(mark)
    return mark


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            fault=None):
    """(result line as a dict, Run) of one run of `cell`."""
    run = Run(cell, seed, seconds, traced)
    ph = run.phases
    t = time.perf_counter()
    builds = kinds.program_attr("gsdf_tpu_torch._build.COUNTS")
    launches = kinds.program_attr("gsdf_tpu_torch.kernels.LAUNCHES")
    ph["import_program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    part = kinds.program_attr(cell.config["builder"])()
    ph["build_part_s"] = time.perf_counter() - t
    req = kinds.load(cell.mix["request"])(cell, part, device, fault)
    del part
    if cell.mix.get("seeded", True) is False:
        log(f"seed {seed} ignored: the {cell.mix['request']} mix sends one request, the "
            f"published part at its published resolution")
    t = time.perf_counter()
    req.warm(run.spans)
    _sync(device)
    ph["warm_s"] = time.perf_counter() - t
    run.spans.clear()
    run.setup_s = time.perf_counter() - t_start
    counts = dict(builds)
    gen = generator.requests(cell.mix, cell.config, seed)
    sampler = Sampler(req.sample_size, seed)
    if traced:
        mark = _traced_window(run, req, gen, sampler, device, launches)
    else:
        _window(run, req, gen, sampler, device)
    built = {k: builds[k] - counts[k] for k in builds}  # in the window alone
    peak = (torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda"
            else 0)
    measured = traced and run.trace is not None and not run.trace.lost
    if measured:
        t = time.perf_counter()
        req.count_work(mark)
        ph["count_s"] = time.perf_counter() - t
    # the program's state goes before the reference runs on the same device
    req.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = req.check(sampler.kept, cell.reference.part(), device)
    if "builds" in cell.limits:
        numbers["builds"] = sum(built.values())
    log(f"window builds: {built['compiles']} compiler runs, {built['loads']} libraries loaded")
    ph["check_s"] = time.perf_counter() - t
    if measured:
        run.device_bound_s = req.bound_s(run.completed)
    compared = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    missing = sorted(set(numbers) - set(cell.limits))
    if missing:
        raise SystemExit(f"limits/{cell.name}.json has no limit for {missing}")
    correct = (run.completed > 0 and run.failed == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end) if run.completed else ():
        mod, qualifier = spec.reader(m["name"])
        value = mod.read(run, qualifier)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": {"memory_peak_bytes": int(peak)}}
    if traced and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["compared"] = compared
    return result, run
