"""Data-, tensor- and spatially-parallel training time on the visible
cards, through the train CLI under `torch.distributed.run` (NCCL), and
SPMD serving against one card.

    python -m pytorch_glow_tpu_torch.scripts.perf_multi [--steps 20] [--rounds 2]
        [--layouts w1,dp4,...]

Layouts, N the number of visible cards (N >= 2, even):
  w1         celeba64 at full width (K=32, L=4, hidden 512, fused):
             1 rank, global batch 128
  dpN        N ranks (data=N), global batch 128: 128/N rows a rank
  dpN_bN     N ranks (data=N), global batch 128*N: 128 rows a rank
  dpN2_tp2   N ranks (data=N/2, model=2), global batch 128
  hq_w1      celebahq256 at full width and depth (256x256, K=32, L=6,
             hidden 512, additive, fused, remat): 1 rank, global batch 64
  hq_spN     N ranks (data=1, model=N, the preset's shard_spatial): each
             rank its 1/N of every sharded level's rows, global batch 64
  hq_dp2_sp2 N ranks (data=N/2, model=2), global batch 64
  serve      `bench_serve`'s SPMD mode on N ranks (`BENCH_SPMD=1`): a
             celeba64 kernel artifact (export depth BENCH_K, 4 by default)
             with a data axis of N against the one-device artifact, b=64
run in turns for `--rounds` rounds (the training layouts), each
`cli.train <preset> --synthetic textured` for `--steps` steps with
steps_per_call 1 and a scalar log every step.  Each run's median step ms
and images/s over steps 2.. come from rank 0's metrics.csv (images/s of
the global batch); step 1's loss of each layout is printed beside the
one-rank layout's of the same preset and batch (the same weights and
batch; only DDI's sum order differs).  Prints the card line, then one
JSON object.  About 40 s a celeba64 run on H100s.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def run(tag: str, nproc: int, preset: str, sets: list[str], steps: int, out: str) -> dict:
    """One launch -> {"step_ms", "images_per_sec", "step1_loss", ...}."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(nproc), "-m", "pytorch_glow_tpu_torch.cli.train", preset, "--synthetic",
            "textured", "--quiet", "--steps", str(steps), "--out-dir", out,
            "--set", "train.steps_per_call=1", "--set", "train.scalar_log_gap=1",
            "--set", "train.plot_gap=0", "--set", "train.eval_gap=0", "--set", "train.swd_gap=0"]
    for s in sets:
        argv += ["--set", s]
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"{tag}: exit {proc.returncode}")
    with open(os.path.join(out, preset, "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss")]
    rates = [float(r["images_per_sec"]) for r in rows[1:]]
    batch = int(next(s for s in sets if s.startswith("train.batch_size=")).split("=")[1])
    med = statistics.median(rates)
    return {"ranks": nproc, "preset": preset, "sets": sets, "batch": batch,
            "step_ms": 1e3 * batch / med,
            "images_per_sec": med, "step_ms_all": [1e3 * batch / r for r in rates],
            "step1_loss": float(rows[0]["loss"])}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--layouts", default=None, help="comma-separated subset (default: all)")
    args = p.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        print(f"perf_multi: needs an even number of cards, 2 or more; {n} visible",
              file=sys.stderr)
        return 2
    layouts = {
        "w1": (1, "celeba64", ["train.batch_size=128"]),
        f"dp{n}": (n, "celeba64", ["train.batch_size=128", f"mesh.data={n}"]),
        f"dp{n}_b{n}": (n, "celeba64", [f"train.batch_size={128 * n}", f"mesh.data={n}"]),
        f"dp{n // 2}_tp2": (n, "celeba64", ["train.batch_size=128", "mesh.model=2"]),
        "hq_w1": (1, "celebahq256", ["train.batch_size=64"]),
        f"hq_sp{n}": (n, "celebahq256", ["train.batch_size=64", f"mesh.model={n}"]),
        f"hq_dp{n // 2}_sp2": (n, "celebahq256", ["train.batch_size=64", "mesh.model=2"]),
        "serve": (n, None, []),
    }
    if args.layouts:
        layouts = {tag: layouts[tag] for tag in args.layouts.split(",")}
    card = card_line()
    print(f"card: {card} x{n}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    results: dict[str, list[dict]] = {tag: [] for tag in layouts if tag != "serve"}
    for r in range(args.rounds):
        for tag, (nproc, preset, sets) in layouts.items():
            if tag == "serve":
                continue
            with tempfile.TemporaryDirectory(prefix=f"perf_multi_{tag}_") as out:
                res = run(tag, nproc, preset, sets, args.steps, out)
            results[tag].append(res)
            print(f"round {r} {tag}: {nproc} ranks, {preset}, global batch {res['batch']}, "
                  f"median step {res['step_ms']:.3f} ms, {res['images_per_sec']:.3f} images/s, "
                  f"step-1 loss {res['step1_loss']!r}", flush=True)
    ones = {(rs[0]["preset"], rs[0]["batch"]): rs[0]["step1_loss"]
            for rs in results.values() if rs[0]["ranks"] == 1}
    summary = {}
    for tag, rs in results.items():
        ref = ones.get((rs[0]["preset"], rs[0]["batch"]))
        summary[tag] = {"ranks": rs[0]["ranks"], "preset": rs[0]["preset"],
                        "global_batch": rs[0]["batch"], "step_ms": [x["step_ms"] for x in rs],
                        "images_per_sec": [x["images_per_sec"] for x in rs],
                        "step1_loss_rel_to_one_rank": (None if ref is None else
                                                       abs(rs[0]["step1_loss"] - ref) / abs(ref))}
    if "serve" in layouts:
        summary["serve"] = serve_spmd(n)
    print(card)
    print(json.dumps({"card": card, "cards": n, "steps": args.steps, "layouts": summary}))
    return 0


def serve_spmd(n: int) -> dict:
    """`bench_serve`'s SPMD mode on n ranks -> its JSON result (rank 0's)."""
    with tempfile.TemporaryDirectory(prefix="perf_multi_serve_") as out:
        env = {**os.environ, "BENCH_SPMD": "1", "BENCH_SPMD_DIR": out}
        env.setdefault("BENCH_K", "4")
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", str(n), "-m",
                               "pytorch_glow_tpu_torch.scripts.bench_serve"],
                              cwd=REPO, capture_output=True, text=True, timeout=1200, env=env)
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"serve: exit {proc.returncode}")
    print(proc.stdout[-4000:], flush=True)
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


if __name__ == "__main__":
    sys.exit(main())
