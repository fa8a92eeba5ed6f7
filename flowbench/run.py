"""Run one cell of the benchmark once and print its result line.

    python3 -m flowbench.run --workload hq256-train --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell's entry in `BENCHMARK.json` names
its configuration (`flowbench/configs/<config>.json`) and its traffic mix
(`flowbench/traffic/<traffic>.json`), whose "kind" names the window's
driver (`flowbench/kinds/<kind>.py`); each metric is read by
`flowbench/metrics/<name before the first dot>.py`, and each number the
cell compares with the reference has its limit in
`flowbench/limits/<workload>.json`.  Nothing here names a cell.

A run: set-up (weights and inputs from the seed, the program built and
warmed on every shape the window uses), the window of `--seconds` (under
torch.profiler recording the card's activity with `--trace 1`, then two
calls more with the host's, which name the idle gaps), then, with the program's state freed,
the plain reference over what the window produced.  The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit, which also end standard
error.  No card, fewer cards than the cell asks for, or the JAX package
loaded once the window has closed: a message on standard error, no
result, and a non-zero exit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / ".flowbench_cache" / _sub)

import torch  # noqa: E402

from flowbench import program, trace as tracelib  # noqa: E402
from flowbench.program import START  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_glow_tpu")
HOST_CALLS = 2  # calls after a traced window that name its idle gaps


@dataclass
class Ctx:
    """One run of one cell: its entry, configuration, mix and run knobs."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int

    @property
    def glow(self) -> dict:
        return self.config["glow"]


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def context(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
            device: str) -> Ctx:
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Ctx(workload, load_json(entry["file"]),
               load_json(f"flowbench/traffic/{cell['traffic']}.json"), seed, seconds, trace,
               device, cell["chips"])


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell prints: its end-to-end ones, or with
    the trace its per-layer ones (a metric without "workloads" is every
    cell's)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The metric's reader: `flowbench/metrics/<base>.py` for "<base>.<mode>"."""
    return importlib.import_module(f"flowbench.metrics.{name.split('.')[0]}")


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def window(cell, ctx: Ctx) -> dict:
    """Call the cell back to back for ctx.seconds, then wait for the
    device: all the calls' work over all the time.  Each call's host time
    is kept (a call that waits for its result gives its latency)."""
    program.sync(ctx.device)
    cuda = torch.device(ctx.device).type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    prof = tracelib.profiler(ctx.device) if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    setup_s = time.time() - START
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    calls, latencies = 0, []
    while True:
        t0 = time.perf_counter()
        cell.call(calls)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        calls += 1
        if t1 >= deadline:
            break
    program.sync(ctx.device)
    window_s = time.perf_counter() - t_start
    if prof is not None:
        prof.__exit__(None, None, None)
    peak_window = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    rec = {"setup_s": setup_s, "window_s": window_s, "calls": calls,
           "images": calls * cell.images_per_call, "latencies_s": latencies,
           "peak_window_bytes": peak_window, "memory_peak_bytes": max(peak_setup, peak_window),
           "trace": tracelib.read(prof) if prof is not None else None, "host_trace": None}
    if prof is not None:
        rec["host_trace"] = host_window(cell, calls, ctx)
    return rec


def host_window(cell, first: int, ctx: Ctx) -> tracelib.Trace:
    """HOST_CALLS more calls after the window, profiled with the host's
    operations, to name the idle gaps by what the host was doing (the
    window itself records the card alone).  Their answers are the window's
    kind and are checked with it; no metric counts them."""
    prof = tracelib.profiler(ctx.device, host=True)
    with prof:
        for i in range(first, first + HOST_CALLS):
            cell.call(i)
        program.sync(ctx.device)
    return tracelib.read(prof)


def judge(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    present, finite and within it."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(bench: dict, ctx: Ctx, limits: dict[str, float]) -> dict:
    """Set up, measure, free the program, check against the reference:
    the result line as a dict (without printing)."""
    kind = importlib.import_module(f"flowbench.kinds.{ctx.traffic['kind']}")
    name, power = program.card(ctx.device)
    print(f"card: {name}, power limit {power}", file=sys.stderr, flush=True)
    cell = kind.Cell(ctx)
    rec = window(cell, ctx)
    rec.update(glow=ctx.glow, batch=cell.images_per_call, chains=kind.CHAINS,
               flops_factor=kind.FLOPS_FACTOR, chips=ctx.chips, card=name, power_limit=power)
    answers, failed = cell.close()
    del cell
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    metrics = {}
    for m in metrics_of(bench, ctx.workload, ctx.trace):
        value = reader(m["name"]).read(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = judge(kind.compare(answers, kind.reference(ctx, answers)), limits)
    device = {"platform": "gpu" if torch.device(ctx.device).type == "cuda" else "cpu",
              "kind": name, "count": ctx.chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": ok, "attempted": rec["calls"], "failed": failed, "metrics": metrics,
            "device": device}
    tr = rec["trace"]
    if tr is not None:
        device.update(busy_s=tr.busy_s(), window_s=rec["window_s"])
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": rec["host_trace"].idle_gaps()}
    line["checks"] = checks
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json("BENCHMARK.json")
    if not any(w["name"] == args.workload for w in bench["workloads"]):
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    ctx = context(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.chips:
        print(f"{args.workload} needs {ctx.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(bench, ctx, load_json(f"flowbench/limits/{args.workload}.json"))
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {', '.join(leaked)}: the JAX package or JAX itself",
              file=sys.stderr)
        return 3
    for key, c in line["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
