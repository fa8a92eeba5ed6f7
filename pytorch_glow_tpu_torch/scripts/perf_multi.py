"""Data- and tensor-parallel training time of celeba64 at full width
(K=32, L=4, hidden 512, fused) on the visible cards, through the train CLI
under `torch.distributed.run` (NCCL).

    python -m pytorch_glow_tpu_torch.scripts.perf_multi [--steps 20] [--rounds 2]

Layouts, N the number of visible cards (N >= 2, even):
  w1         1 rank, global batch 128
  dpN        N ranks (data=N), global batch 128: 128/N rows a rank
  dpN_bN     N ranks (data=N), global batch 128*N: 128 rows a rank
  dpN2_tp2   N ranks (data=N/2, model=2), global batch 128
run in turns for `--rounds` rounds, each `cli.train celeba64 --synthetic
textured` for `--steps` steps with steps_per_call 1 and a scalar log every
step.  Each run's median step ms and images/s over steps 2.. come from
rank 0's metrics.csv (images/s of the global batch); step 1's loss of each
layout of global batch 128 is printed beside w1's (the same weights and
batch; only DDI's sum order differs).  Prints the card line, then one
JSON object.  About 40 s a run on H100s.
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


def run(tag: str, nproc: int, sets: list[str], steps: int, out: str) -> dict:
    """One launch -> {"step_ms", "images_per_sec", "step1_loss", ...}."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(nproc), "-m", "pytorch_glow_tpu_torch.cli.train", "celeba64", "--synthetic",
            "textured", "--quiet", "--steps", str(steps), "--out-dir", out,
            "--set", "train.steps_per_call=1", "--set", "train.scalar_log_gap=1"]
    for s in sets:
        argv += ["--set", s]
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"{tag}: exit {proc.returncode}")
    with open(os.path.join(out, "celeba64", "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss")]
    rates = [float(r["images_per_sec"]) for r in rows[1:]]
    batch = int(next(s for s in sets if s.startswith("train.batch_size=")).split("=")[1])
    med = statistics.median(rates)
    return {"ranks": nproc, "sets": sets, "batch": batch, "step_ms": 1e3 * batch / med,
            "images_per_sec": med, "step_ms_all": [1e3 * batch / r for r in rates],
            "step1_loss": float(rows[0]["loss"])}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        print(f"perf_multi: needs an even number of cards, 2 or more; {n} visible",
              file=sys.stderr)
        return 2
    layouts = {
        "w1": (1, ["train.batch_size=128"]),
        f"dp{n}": (n, ["train.batch_size=128", f"mesh.data={n}"]),
        f"dp{n}_b{n}": (n, [f"train.batch_size={128 * n}", f"mesh.data={n}"]),
        f"dp{n // 2}_tp2": (n, ["train.batch_size=128", "mesh.model=2"]),
    }
    card = card_line()
    print(f"card: {card} x{n}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    results: dict[str, list[dict]] = {tag: [] for tag in layouts}
    for r in range(args.rounds):
        for tag, (nproc, sets) in layouts.items():
            with tempfile.TemporaryDirectory(prefix=f"perf_multi_{tag}_") as out:
                res = run(tag, nproc, sets, args.steps, out)
            results[tag].append(res)
            print(f"round {r} {tag}: {nproc} ranks, global batch {res['batch']}, median step "
                  f"{res['step_ms']:.3f} ms, {res['images_per_sec']:.3f} images/s, step-1 loss "
                  f"{res['step1_loss']!r}", flush=True)
    ref = results["w1"][0]["step1_loss"]
    summary = {tag: {"ranks": rs[0]["ranks"], "global_batch": rs[0]["batch"],
                     "step_ms": [x["step_ms"] for x in rs],
                     "images_per_sec": [x["images_per_sec"] for x in rs],
                     "step1_loss_rel_to_w1": (abs(rs[0]["step1_loss"] - ref) / abs(ref)
                                              if rs[0]["batch"] == 128 else None)}
               for tag, rs in results.items()}
    print(card)
    print(json.dumps({"card": card, "cards": n, "steps": args.steps, "layouts": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
