"""A training run's boundaries and step time, read from what the trainer
logged.

    python -m pytorch_glow_tpu_torch.scripts.run_summary cifar10 --synthetic textured \\
        --steps 2000 [any other cli.train flag]

Takes the flags of the `cli.train` run and reads its metrics.csv and
best.json under out_dir/name.  Prints one JSON object: the median ms of a
train step between boundaries (from the images/sec of the scalar-log
windows that hold no boundary's time; the first window, which pays the
warm-up, is left out), each plot, eval and SWD boundary as logged (its
ms, flow-step launches and host parts), each rolling snapshot's loop-visible
`save_ms`, the eval and SWD metrics, and the best snapshot.  The times are those of the machine that trained.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import sys

KINDS = ("plot", "eval", "swd")
HOST_PARTS = {"eval": "best_save_ms", "swd": "swd_host_ms"}


def summarize_run(rows: list[dict], batch_size: int, scalar_log_gap: int) -> dict:
    """The summary of a run's metrics.csv rows."""
    marks = {int(r["step"]) for r in rows if any(r.get(f"{k}_ms") for k in (*KINDS, "save"))}
    # A window (s - gap, s] holds a boundary's time when one ran at its start.
    step_ms = [1e3 * batch_size / float(r["images_per_sec"]) for r in rows
               if r.get("images_per_sec") and float(r["images_per_sec"]) > 0
               and int(r["step"]) > scalar_log_gap
               and int(r["step"]) - scalar_log_gap not in marks]
    boundaries = []
    for r in rows:
        for k in KINDS:
            if r.get(f"{k}_ms"):
                b = {"kind": k, "step": int(r["step"]), "ms": float(r[f"{k}_ms"]),
                     "launches": int(float(r[f"{k}_launches"]))}
                if k in HOST_PARTS:
                    b[HOST_PARTS[k]] = float(r[HOST_PARTS[k]])
                boundaries.append(b)
    metrics = ("eval_nll", "eval_nll_raw", "recon_err_max_u8", "best_eval_nll", "swd_x1e3")
    return {"median_step_ms": statistics.median(step_ms) if step_ms else None,
            "step_windows": len(step_ms),
            "boundaries": boundaries,
            "saves": [{"step": int(r["step"]), "save_ms": float(r["save_ms"])}
                      for r in rows if r.get("save_ms")],
            "evals": [{"step": int(r["step"]), **{m: float(r[m]) for m in metrics if r.get(m)}}
                      for r in rows if r.get("eval_nll") or r.get("swd_x1e3")]}


def main(argv=None) -> dict:
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

    prof = train_cli.resolve_profile(train_cli.parse_args(sys.argv[1:] if argv is None
                                                          else argv))
    run = os.path.join(prof.out_dir, prof.name)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    out = {"run": run, **summarize_run(rows, prof.train.batch_size, prof.train.scalar_log_gap),
           "best": CheckpointManager(os.path.join(run, "checkpoints")).best_info()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
