"""Multi-rank preemption drill on the CPU: a SIGTERM to ONE of two gloo
ranks stops both at the same step, with a snapshot, and a rerun resumes.

Counterpart of `scripts/multihost_preempt_smoke.py`.  The trainer
MAX-all-reduces its SIGTERM flag at `scalar_log_gap` boundaries
(`train/trainer._preempt_stop`), so the rank that got no signal stops at
the same step instead of waiting in the next step's all-reduce.  Checks:
(a) both ranks exit 0 with `"preempted": true` at one step, (b) the
snapshot of that step is on disk, (c) a second wave resumes from it on
both ranks and trains to its end.

  python -m pytorch_glow_tpu_torch.scripts.multihost_preempt_smoke

Prints one JSON line {"multihost_preempt_smoke": "OK", ...}; exits non-zero
when a check fails.  About 15 s.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import time

from pytorch_glow_tpu_torch.scripts import _smoke_common as sc

MODULE = "pytorch_glow_tpu_torch.scripts.multihost_preempt_smoke"
FOREVER = 100_000
MORE = 4  # steps the second wave trains past the stop


def profile(out_dir: str, num_steps: int):
    from pytorch_glow_tpu_torch.config import (
        DataConfig, GlowConfig, OptimConfig, Profile, TrainConfig,
    )

    return Profile(
        name="mh-preempt",
        glow=GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2),
        optim=OptimConfig(lr=1e-3, warmup_steps=10),
        train=TrainConfig(batch_size=8, num_steps=num_steps, scalar_log_gap=2, plot_gap=0,
                          checkpoint_gap=0, seed=0),
        data=DataConfig(name="synthetic"),
        out_dir=out_dir,
    )


def child(argv) -> None:
    args, rest = sc.rank_args(argv)
    out_dir, num_steps = rest[0], int(rest[1])
    sc.install_child_watchdog()
    sc.init_gloo(args.rank, args.world, args.store)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train

    built = build(profile(out_dir, num_steps), device="cpu")
    result = train(built, quiet=True)
    print(json.dumps({"rank": args.rank, "start_step": built.start_step,
                      "final_step": result["final_step"],
                      "preempted": bool(result.get("preempted", False))}), flush=True)
    dist.destroy_process_group()


def _wave(tmp: str, wave: str, num_steps: int, signal_after_rows: bool):
    out_dir = os.path.join(tmp, "out")
    argv = ["-m", MODULE, "--child", out_dir, str(num_steps)]
    procs = sc.spawn_ranks(argv, 2, os.path.join(tmp, f"store-{wave}"))
    try:
        if signal_after_rows:
            csv = os.path.join(out_dir, "mh-preempt", "metrics.csv")
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if os.path.isfile(csv) and sum(1 for _ in open(csv)) >= 3:
                    break
                if any(p.poll() is not None for p in procs):
                    break
                time.sleep(0.2)
            else:
                raise RuntimeError("timed out waiting for training rows")
            procs[1].send_signal(signal.SIGTERM)  # one rank only
        results = sc.communicate_all(procs, timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, rc, err) for r, (rc, _, err) in enumerate(results) if rc != 0]
    if bad:
        raise RuntimeError("\n".join(f"[rank {r}] rc={rc}\n{err[-3000:]}" for r, rc, err in bad))
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in results]


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="mh_preempt_") as tmp:
        first = _wave(tmp, "a", FOREVER, signal_after_rows=True)
        stops = {o["final_step"] for o in first}
        stop = min(stops)
        snapshot = os.path.isfile(os.path.join(tmp, "out", "mh-preempt", "checkpoints",
                                               f"{stop}.pt"))
        second = _wave(tmp, "b", stop + MORE, signal_after_rows=False)
    ok = (len(stops) == 1 and stop < FOREVER and all(o["preempted"] for o in first)
          and snapshot
          and all(o["start_step"] == stop and o["final_step"] == stop + MORE
                  and not o["preempted"] for o in second))
    print(json.dumps({"multihost_preempt_smoke": "OK" if ok else "FAILED", "procs": first,
                      "snapshot": snapshot, "resume": second, "resumed_to": stop + MORE}))
    return 0 if ok else 1


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.argv.remove("--child")
        child(sys.argv[1:])
    else:
        sys.exit(main())
