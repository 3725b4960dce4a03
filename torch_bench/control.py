"""The readings that a cell's limits are set from, for each seed given:

- `program`: the numbers the check compares in a run of the cell (a short
  window at the cell's own load, the same sample of answers as a run);
- `control`: the same numbers when the plain reference, its part evaluated
  in bfloat16 (the precision below the float32 the configuration states),
  takes the program's place on the same requests.

    python3 torch_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--out FILE]

One JSON line a seed on standard output (and in FILE). The benchmark's own
runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_numbers(cell, seed: int, device, dtype=None, baked: bool = True) -> dict:
    """The compared numbers of the reference in `dtype` (bfloat16) in the
    program's place, on a sample of the seed's requests."""
    import torch

    from torch_bench import generator, harness, kinds

    dtype = dtype or torch.bfloat16
    part = kinds.program_attr(cell.config["builder"])()
    req = kinds.load(cell.mix["request"])(cell, part, device)
    ref_part = cell.reference.part()
    gen = generator.requests(cell.mix, cell.config, seed)
    sampler = harness.Sampler(req.sample_size, seed)
    state: dict = {}
    for params in itertools.islice(gen, req.control_requests):
        sampler.offer(req.control_sample(params, state))
    answers = [req.control_answer(s, ref_part, device, dtype) for s in sampler.kept]
    req.summaries = [req.summary(a) for a in answers]
    numbers = req.check(answers, ref_part, device)
    numbers.update(req.control_extra(sampler.kept, baked))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Program and control readings per seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--baked-seeds", type=int, default=3,
                    help="seeds whose control also renders one edit without the parametric "
                         "path (one nvcc run each)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the package by its name, never its files as top-level modules
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]
    import torch

    from torch_bench import harness, spec

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    cell = spec.load(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            result, _ = harness.execute(cell, seed, args.seconds, False, device,
                                        time.perf_counter())
            program = {k: v["value"] for k, v in result["compared"].items()}
            line = json.dumps({"workload": cell.name, "seed": seed, "correct": result["correct"],
                               "program": program,
                               "control": control_numbers(cell, seed, device,
                                                          baked=i < args.baked_seeds)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
