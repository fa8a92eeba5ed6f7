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

SPMD mode (BENCH_SPMD=1, under `torch.distributed.run --nproc_per_node N`,
one card a rank, each rank seeing its card alone as cuda:0 (an exported
CUDA program keeps the device index it was exported on), NCCL;
`scripts/perf_multi.py` runs it): every rank builds
the same model; rank 0 exports a kernel artifact of sample and nll for one
device and one with a data axis of N (`serve.export_artifact(mesh=)`) into
BENCH_SPMD_DIR; every rank loads the SPMD one, which serves each rank's
batch / N rows and gathers the outputs.  Rank 0 checks the SPMD sample
bitwise and its nll within rtol 1e-5 against the one-device artifact's,
then times, in turns for `ROUNDS` rounds, the one-device artifact alone
and the SPMD artifact on all ranks (CUDA events on rank 0 around each
call, a barrier between), and prints one JSON line.
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


def _model(cfg, batch: int):
    """The preset's model (random weights from seed 0, DDI on one batch) and
    that batch."""
    from pytorch_glow_tpu_torch.models.glow import init_glow

    model = init_glow(cfg, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (batch, *cfg.image_shape), dtype=torch.uint8,
                           generator=gen).cuda()
    model.ddi_init(model.dequantize(model.preprocess(images),
                                    torch.Generator(device="cuda").manual_seed(2)))
    return model, images


def spmd_main(cfg, batch: int, iters: int, card: str) -> dict:
    """The SPMD mode (module docstring)."""
    import torch.distributed as dist

    from pytorch_glow_tpu_torch import serve
    from pytorch_glow_tpu_torch.parallel import distributed as pd

    pd.maybe_initialize(pd.local_device())
    n, rank = dist.get_world_size(), dist.get_rank()
    out = os.environ["BENCH_SPMD_DIR"]
    model, images = _model(cfg, batch)
    if rank == 0:
        for name, mesh in (("one", None), ("spmd", {"data": n})):
            serve.export_artifact(model, cfg, os.path.join(out, name), batch, ("sample", "nll"),
                                  keep_kernels=True, mesh=mesh)
    del model
    dist.barrier()
    spmd = serve.load_artifact(os.path.join(out, "spmd"))
    one = serve.load_artifact(os.path.join(out, "one")) if rank == 0 else None
    got_s, got_n = spmd.sample(seed=3, temperature=0.7), spmd.nll(images)
    check = None
    if rank == 0:
        want_s, want_n = one.sample(seed=3, temperature=0.7), one.nll(images)
        check = {"sample_bitwise": bool(torch.equal(got_s, want_s)),
                 "nll_max_rel": float(((got_n - want_n).abs() / want_n.abs()).max())}
        print(f"SPMD artifact on {n} ranks against one device: {check}", flush=True)
    routes = {"one": {"sample": lambda: one.sample(seed=0, temperature=0.7),
                      "nll": lambda: one.nll(images)},
              f"spmd{n}": {"sample": lambda: spmd.sample(seed=0, temperature=0.7),
                           "nll": lambda: spmd.nll(images)}}
    ms = {f"{route} {what}": [] for route in routes for what in ("sample", "nll")}
    for _ in range(ROUNDS):
        for route, fns in routes.items():
            for what, fn in fns.items():
                if route == "one" and rank != 0:
                    dist.barrier()
                    continue
                t = _events_ms(fn, iters)
                if rank == 0:
                    ms[f"{route} {what}"].append(t)
                dist.barrier()
    dist.destroy_process_group()
    rows = {key: {"ms": v, "images_per_s": [batch / (t / 1e3) for t in v]}
            for key, v in ms.items()}
    result = {"preset": "spmd", "batch": batch, "K": cfg.K, "ranks": n, "card": card,
              "check": check, "rows": rows}
    if rank == 0:
        for key, row in rows.items():
            print(f"{key}: " + " / ".join(f"{t:.3f}" for t in row["ms"]) + " ms, "
                  + " / ".join(f"{v:.1f}" for v in row["images_per_s"]) + " img/s")
        print(f"card for these times: {card}")
        print(json.dumps(result))
    return result


def main() -> dict:
    if os.environ.get("BENCH_SPMD", "0") == "1" and "LOCAL_RANK" in os.environ:
        # An exported CUDA program runs on the device index it was exported
        # on: each rank sees its own card as cuda:0 (set before CUDA starts).
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ["LOCAL_RANK"]
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve needs a CUDA card")
    from pytorch_glow_tpu_torch import serve
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.inference import Inferer
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
    if os.environ.get("BENCH_SPMD", "0") == "1":
        return spmd_main(cfg, batch, iters, card)
    model, images = _model(cfg, batch)
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
