"""Device-memory report of a profile's train step and serving sample.

Counterpart of `scripts/memory_report.py`, which compiles the JAX train
step and sample function without running them and prints XLA's buffer
assignment.  The port's hand kernels have no such ahead-of-time analysis,
so this runs them once: `build` (model, optimizer state, EMA, DDI on a
synthetic textured batch), one train call at the profile's batch and one
T=0.7 sample, each from a fresh peak counter, and reports

* `peak_bytes`: `torch.cuda.max_memory_allocated` over the call;
* `argument_bytes`: what the state holds going in (parameters, optimizer
  state, EMA), and `temp_bytes` = peak - arguments;
* `top_sites`: the allocation sites (the port's file:line:function
  nearest each allocation) holding the most bytes at the train call's
  peak, replayed from `torch.cuda.memory._snapshot()`'s trace;
* the headroom against the card's `total_memory` (or `--hbm-gb`).

    python -m pytorch_glow_tpu_torch.scripts.memory_report celebahq256
    python -m pytorch_glow_tpu_torch.scripts.memory_report cifar10 --batch-size 16 --cpu

With `--cpu` nothing is measured: the report holds the byte counts the
host knows (parameters, optimizer state, EMA) and null for every device
number, with a "note" saying so.  Prints one JSON line, the JAX script's
keys where they mean the same.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

# Frames of the port's own code name an allocation site.
_PORT = os.sep + "pytorch_glow_tpu_torch" + os.sep


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("profile", help="profile JSON path or preset name")
    p.add_argument("--batch-size", type=int, default=None, help="override train.batch_size")
    p.add_argument("--sample-batch", type=int, default=None,
                   help="serving sample batch (default: the train batch)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="device memory to report headroom against (default: the card's)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="profile overrides")
    p.add_argument("--sites", type=int, default=10, help="allocation sites to list")
    p.add_argument("--cpu", action="store_true",
                   help="report only what the host knows; measure nothing")
    return p.parse_args(argv)


def _site(frames: list[dict]) -> str:
    for f in frames:
        if _PORT in f.get("filename", ""):
            name = f["filename"].split(_PORT, 1)[1]
            return f"{name}:{f['line']}:{f['name']}"
    return "(outside the port)" if frames else "(no stack)"


def peak_sites(snapshot: dict, device: int, top: int) -> list[dict]:
    """The allocation sites live at the trace's peak of allocated bytes,
    largest first: replays the alloc / free events of `device`'s trace."""
    live: dict[int, tuple[int, str]] = {}
    cur = peak = 0
    at_peak: dict[int, tuple[int, str]] = {}
    for ev in snapshot["device_traces"][device]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _site(ev.get("frames", [])))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    sites: dict[str, list[int]] = {}
    for size, site in at_peak.values():
        s = sites.setdefault(site, [0, 0])
        s[0] += size
        s[1] += 1
    ranked = sorted(sites.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"site": k, "bytes": v[0], "allocations": v[1]} for k, v in ranked]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pytorch_glow_tpu_torch.cli import train as train_cli

    ns = train_cli.parse_args([args.profile, "--synthetic", "textured", "--quiet",
                               *(["--batch-size", str(args.batch_size)] if args.batch_size
                                 else []), *sum((["--set", o] for o in args.overrides), [])])
    prof = train_cli.resolve_profile(ns)
    scratch = tempfile.mkdtemp(prefix="memory_report_")  # no snapshot is read or kept
    try:
        return _report(args, prof.replace(out_dir=scratch))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _report(args, prof) -> dict:
    import torch

    from pytorch_glow_tpu_torch.train.builder import build, labels_to_onehot

    g, t = prof.glow, prof.train
    device = torch.device("cpu" if args.cpu else "cuda")
    built = build(prof, device=device)
    state = built.state
    params = [p for p in state["model"].parameters()]
    param_bytes = _nbytes(params)
    opt_bytes = _nbytes(v for v in state["opt_state"].values())
    ema_bytes = _nbytes(state.get("ema", []))
    sample_n = args.sample_batch or t.batch_size
    report = {
        "profile": prof.name,
        "platform": "cpu" if args.cpu else "gpu",
        "device": "cpu" if args.cpu else torch.cuda.get_device_name(0),
        "image_shape": list(g.image_shape),
        "train_batch": t.batch_size,
        "steps_per_call": max(1, t.steps_per_call),
        "flowstep_impl": g.flowstep_impl,
        "param_bytes": param_bytes,
        "opt_state_bytes": opt_bytes,
        "ema_bytes": ema_bytes,
    }
    if args.cpu:
        built.data.close()
        report.update(train=None, sample={"batch": sample_n}, hbm_gb=args.hbm_gb,
                      train_fits=None, train_hbm_headroom_gb=None,
                      note="--cpu: nothing measured; the device numbers need a run on the card")
        print(json.dumps(report))
        return report

    spc = max(1, t.steps_per_call)
    batches = [next(built.data) for _ in range(spc)]
    built.data.close()
    x = torch.stack([b["image"] for b in batches]) if spc > 1 else batches[0]["image"]
    ys = [labels_to_onehot(b, prof) for b in batches]
    y = None if ys[0] is None else (torch.stack(ys) if spc > 1 else ys[0])
    arguments = param_bytes + opt_bytes + ema_bytes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    state, _ = built.train_step(state, x, y)
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    train_stats = {"peak_bytes": peak, "argument_bytes": arguments,
                   "temp_bytes": peak - arguments, "resident_before_bytes": base,
                   "top_sites": peak_sites(snapshot, torch.cuda.current_device(), args.sites)}
    del snapshot, x

    model = state["model"]
    labels = None if y is None else (y[0] if spc > 1 else y)[:sample_n]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model.sample(sample_n, 0.7, torch.Generator(device=device).manual_seed(0), labels)
    torch.cuda.synchronize()
    speak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    hbm = int(args.hbm_gb * 2**30) if args.hbm_gb else total
    report.update(
        train=train_stats,
        sample={"batch": sample_n, "peak_bytes": speak, "temp_bytes": speak - arguments},
        hbm_gb=round(hbm / 2**30, 3), train_fits=bool(peak <= hbm),
        train_hbm_headroom_gb=round((hbm - peak) / 2**30, 3))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
