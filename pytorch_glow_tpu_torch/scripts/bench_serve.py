"""Serving throughput: the exported artifacts against the live model.

    python -m pytorch_glow_tpu_torch.scripts.bench_serve

Counterpart of the repository's `scripts/bench_serve.py`.  Builds the
preset's model (random weights from seed 0, then DDI on one batch),
exports it twice (`serve.export_artifact`: the portable unfused artifact
and, with `keep_kernels`, the artifact of the hand-written kernels, each
with `sample` and `nll` at the batch), loads both, and measures in one
process, in turns (live, portable, kernels, then the reverse order, for
`ROUNDS` rounds), the images/s of a T=0.7 `sample` and of `nll` on the
three routes: the live `Inferer`, the portable artifact and the kernel
artifact.  Each call is timed with CUDA events (median of `BENCH_ITERS`
calls after warm-up); the wall time of a call with its sync is printed
apart, as are each call's flow-step kernel launches.  Then the cold start
of each artifact: export and save seconds (from the manifest), load
seconds and the first call's.  Prints the card's name and power limit and
one JSON line.  Needs a CUDA card.

Env: BENCH_PRESET (celeba64), BENCH_BATCH (64), BENCH_ITERS (10),
BENCH_K (the preset's K: the export depth; a cut depth is printed),
BENCH_PROFILE (0; 1 adds torch.profiler's table of host and device time by
op for one call of each route, and the op count of each exported graph).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

ROUNDS = 2


def _events_ms(fn, iters: int) -> float:
    """Median ms of one call by CUDA events, after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _wall_ms(fn, iters: int) -> float:
    """Median wall ms of one call and its sync."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _profile(calls: dict, served: dict) -> None:
    """torch.profiler's top ops by self host time for one call of each
    route and function, and each exported graph's op count."""
    from torch.profiler import ProfilerActivity, profile

    for name, sm in served.items():
        for fn in ("sample", "nll"):
            nodes = [n for n in sm.fn(fn).graph.nodes if n.op == "call_function"]
            print(f"{name} {fn}: {len(nodes)} ops in the exported graph")
    for route, fns in calls.items():
        for what, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f"--- profile {route} {what}")
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve needs a CUDA card")
    from pytorch_glow_tpu_torch import serve
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.inference import Inferer
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.ops import _build
    from pytorch_glow_tpu_torch.ops import flowstep as fs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    preset = os.environ.get("BENCH_PRESET", "celeba64")
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    cfg = PRESETS[preset].glow
    depth = int(os.environ.get("BENCH_K", cfg.K))
    if depth != cfg.K:
        print(f"# export depth cut: K={depth} of the preset's {cfg.K}")
        cfg = dataclasses.replace(cfg, K=depth)
    _build.library()
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (batch, *cfg.image_shape), dtype=torch.uint8,
                           generator=gen).cuda()
    model.ddi_init(model.dequantize(model.preprocess(images),
                                    torch.Generator(device="cuda").manual_seed(2)))
    live = Inferer(model)
    print(f"# {preset} b{batch} K={cfg.K} L={cfg.L} hidden {cfg.hidden_channels} "
          f"{cfg.flowstep_impl} {cfg.compute_dtype}, torch {torch.__version__}")

    cold, served = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, keep in (("portable", False), ("kernels", True)):
            out = os.path.join(tmp, name)
            man = serve.export_artifact(model, cfg, out, batch, ("sample", "nll"),
                                        keep_kernels=keep)
            t0 = time.perf_counter()
            sm = serve.load_artifact(out)
            for fn in ("sample", "nll"):
                sm.fn(fn)
            t1 = time.perf_counter()
            sm.nll(images)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sm.sample(seed=0, temperature=0.7)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            cold[name] = {
                "export_s": {f: m["seconds"]["export"] for f, m in man["functions"].items()},
                "save_s": {f: m["seconds"]["save"] for f, m in man["functions"].items()},
                "bytes": {f: m["bytes"] for f, m in man["functions"].items()},
                "load_s": t1 - t0, "first_nll_s": t2 - t1, "first_sample_s": t3 - t2}
            served[name] = sm
            print(f"cold start {name}: {json.dumps(cold[name])}", flush=True)

        seeds = iter(range(10**6))
        calls = {
            "live": {"sample": lambda: live.sample(
                         batch, 0.7, torch.Generator(device="cuda").manual_seed(next(seeds))),
                     "nll": lambda: live.nll(images)},
            **{name: {"sample": lambda sm=sm: sm.sample(seed=next(seeds), temperature=0.7),
                      "nll": lambda sm=sm: sm.nll(images)}
               for name, sm in served.items()},
        }
        launches = {}
        for route, fns in calls.items():
            for what, fn in fns.items():
                fs.reset_launches()
                fn()
                torch.cuda.synchronize()
                launches[f"{route} {what}"] = {k: v for k, v in fs.launches.items() if v}
        print(f"flow-step launches per call: {launches}")
        if os.environ.get("BENCH_PROFILE", "0") == "1":
            _profile(calls, served)
        ms = {f"{route} {what}": [] for route in calls for what in ("sample", "nll")}
        wall = {key: [] for key in ms}
        order = list(calls)
        for r in range(ROUNDS):
            for route in (order if r % 2 == 0 else order[::-1]):
                for what, fn in calls[route].items():
                    ms[f"{route} {what}"].append(_events_ms(fn, iters))
                    wall[f"{route} {what}"].append(_wall_ms(fn, iters))
    rows = {key: {"ms": v, "images_per_s": [batch / (t / 1e3) for t in v],
                  "wall_ms": wall[key]} for key, v in ms.items()}
    for key, row in rows.items():
        print(f"{key}: " + " / ".join(f"{t:.3f}" for t in row["ms"]) + " ms (events), "
              + " / ".join(f"{v:.1f}" for v in row["images_per_s"]) + " img/s; wall "
              + " / ".join(f"{t:.3f}" for t in row["wall_ms"]) + " ms")
    result = {"preset": preset, "batch": batch, "K": cfg.K, "card": card, "rows": rows,
              "cold": cold, "launches": launches}
    print(f"card for these times: {card}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
