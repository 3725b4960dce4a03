"""Run one cell of the benchmark once, on the card, and print its result.

    python3 torch_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a configuration
and a traffic mix under torch_bench/. The run builds the part, warms the
cell's request shape, issues requests for `--seconds` in a closed loop,
checks a seeded sample of the answers against the plain reference, and
prints the medians on standard error and, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `compared`, each number
the check compared beside its limit. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 3; in a
checkout without the program (gsdf_tpu_torch), with 2; where the process
holds JAX or the JAX package once the window has closed, with 4.
"""
import time

T_START = time.perf_counter()
#: the process's own start on the same clock (Linux: /proc/self/stat's
#: start time in clock ticks since boot, CLOCK_MONOTONIC's origin there)
try:
    with open("/proc/self/stat") as _f:
        _ticks = int(_f.read().rsplit(")", 1)[1].split()[19])
    PROCESS_START = min(T_START, _ticks / __import__("os").sysconf("SC_CLK_TCK"))
except (OSError, ValueError, IndexError):
    PROCESS_START = T_START

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


#: top-level modules the run's process may not hold once its window has
#: closed: JAX and the JAX package the program was ported from
BARRED = frozenset(("jax", "jaxlib", "flax", "gsdf_tpu"))


def barred_modules(names) -> list:
    """The barred top-level modules among module names (whole names: the
    port, gsdf_tpu_torch, is not gsdf_tpu)."""
    return sorted({n.split(".", 1)[0] for n in names} & BARRED)


def _card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None) -> int:
    args = _args(argv)
    # the package by its name, never its files as top-level modules (its
    # `trace` would hide the standard library's)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]
    phases = {"python_start_s": T_START - PROCESS_START}
    t = time.perf_counter()
    import torch

    phases["import_torch_s"] = time.perf_counter() - t
    from torch_bench import spec

    cell = spec.load(args.workload)
    if importlib.util.find_spec("gsdf_tpu_torch") is None:
        print(f"the program gsdf_tpu_torch is not in {ROOT}: no result", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}: "
              "no result", file=sys.stderr)
        return 3
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    phases["cuda_context_s"] = time.perf_counter() - t
    from torch_bench import harness

    result, run = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device,
                                  PROCESS_START)
    phases.update(run.phases)
    found = barred_modules(list(sys.modules))
    if found:
        print(f"the run's process holds {found}: no result", file=sys.stderr)
        return 4
    log = harness.log
    log("card:", _card_limit())
    log("phases (s):", json.dumps(phases))
    lat = sorted(run.latencies)
    if lat:
        from torch_bench.stats import percentile

        log(f"requests: window {run.window_s:.6f} s, {run.completed} completed of "
            f"{run.attempted}, latency median {percentile(lat, 50) * 1e3:.6f} ms, p95 "
            f"{percentile(lat, 95) * 1e3:.6f} ms over {len(lat)} samples")
    if run.trace is not None:
        t = run.trace
        log(f"trace: {t.kernels} kernels, {t.host_launches} kernel launch calls, "
            f"{t.unmatched} without their kernel, lost events: {t.lost}")
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    compared = result.pop("compared")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": cell.chips, **result["device"]}
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
