"""Readings that set a cell's limits, at the cell's own size, many seeds in
one process (the benchmark's runs never do this):

* program: the program's numbers against the f32 reference, as a run
  compares them (a short window: `--seconds`);
* control: the reference put in the program's place with its coupling
  nets in scaled float8 e4m3 (`reference.glow.fp8`), the step below the
  configuration's bf16, against the f32 reference;
* each of the cell's faults (its kind's `FAULTS`), planted in the program.

Every seed runs the program once, and the f32 reference once over what it
produced.

    python3 -m flowbench.control --workload c64-sample --seeds 11,12,13 --what program,control

Prints one JSON line per seed and reading, then the largest and smallest
of each number over the seeds.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from flowbench import run
from flowbench.reference import glow as ref


def program_answers(ctx, kind) -> dict:
    """The program's answers of one short run of the cell."""
    cell = kind.Cell(ctx)
    run.window(cell, ctx)
    answers, _ = cell.close()
    del cell
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    return answers


def seed_readings(ctx, kind, whats: list[str]):
    """(what, the numbers) for each reading of one seed."""
    answers = program_answers(ctx, kind)
    theirs = kind.reference(ctx, answers)
    for what in whats:
        if what == "program":
            yield what, kind.compare(answers, theirs)
        elif what == "control":
            yield what, kind.compare(kind.reference(ctx, answers, quant=ref.fp8), theirs)
        else:
            with kind.FAULTS[what]():
                planted = program_answers(ctx, kind)
            # A train fault follows the same steps; a sample fault's answers
            # depend on the window's calls, so the reference follows them.
            same = theirs if ctx.traffic["kind"] == "train" else kind.reference(ctx, planted)
            yield what, kind.compare(planted, same)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings for a cell's limits.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default="program,control",
                   help="program, control and fault names, comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    bench = run.load_json("BENCHMARK.json")
    seen: dict[str, dict[str, list[float]]] = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = run.context(bench, args.workload, seed, args.seconds, False, "cuda")
        kind = importlib.import_module(f"flowbench.kinds.{ctx.traffic['kind']}")
        for what, got in seed_readings(ctx, kind, args.what.split(",")):
            print(json.dumps({"seed": seed, "what": what, **got}), flush=True)
            for k, v in got.items():
                seen.setdefault(what, {}).setdefault(k, []).append(v)
    for what, nums in seen.items():
        for k, vs in nums.items():
            print(json.dumps({"what": what, "number": k, "max": max(vs), "min": min(vs),
                              "n": len(vs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
