"""Learning-rate stability probe: a profile's lr blow-up threshold in one run.

Counterpart of `scripts/lr_probe.py`.  Trains with an exponential lr ramp
(the lr-range test) through the port's production chain: `build` (DDI,
or a snapshot's state with `--out-dir`), the optimizer of
`train/optim.py` (clipping, skip-nonfinite, accumulation) with its
schedule replaced by the ramp, and the train step of `train/step.py`.
It reports the lr at the onset of instability, detected as sustained
grad-norm growth over its rolling median (three suspect calls in a row,
each above the last, the last more than 4x the first) or a non-finite
loss or grad norm.

    python -m pytorch_glow_tpu_torch.scripts.lr_probe celebahq256 --lr0 1e-5 --lr1 3e-3 \\
        --steps 1500 --spc 5
    python -m pytorch_glow_tpu_torch.scripts.lr_probe cifar10 --cpu --batch-size 16

Prints one JSON line: {"onset_lr", "onset_step", "max_stable_lr",
"recommended_peak": onset / 2, "clean", ...} (onset_lr null: a clean ramp).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import statistics
import sys
import tempfile

SYNTHETIC = {"uniform": "synthetic", "smooth": "synthetic_smooth",
             "textured": "synthetic_textured"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("profile", help="profile JSON path or preset name")
    p.add_argument("--lr0", type=float, default=1e-5, help="ramp start lr")
    p.add_argument("--lr1", type=float, default=3e-3, help="ramp end lr")
    p.add_argument("--steps", type=int, default=1000, help="total ramp steps")
    p.add_argument("--spc", type=int, default=5, help="train steps per call")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", default="textured", choices=sorted(SYNTHETIC),
                   help="synthetic data family (default textured)")
    p.add_argument("--data-root", default=None, help="probe on a dataset instead")
    p.add_argument("--growth", type=float, default=8.0,
                   help="suspect when grad_norm > growth x its rolling median")
    p.add_argument("--window", type=int, default=8, help="rolling-median window (calls)")
    p.add_argument("--min-steps", type=int, default=100,
                   help="detection arms only after this many steps")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="override any profile field")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=None,
                   help="probe from a training run's snapshot (its out_dir)")
    p.add_argument("--best", action="store_true", help="with --out-dir: the best snapshot")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def ramp_schedule(lr0: float, lr1: float, start: int, total: int):
    """Optimizer count (tensor) -> lr0 * (lr1 / lr0) ** clip((count - start) / total)."""
    import torch

    def schedule(count):
        frac = torch.clamp((count.float() - start) / float(max(1, total)), 0.0, 1.0)
        return lr0 * (lr1 / lr0) ** frac

    return schedule


class OnsetDetector:
    """The JAX probe's rule over (step, lr, loss, grad_norm) per call."""

    def __init__(self, lr0: float, growth: float, window: int, min_steps: int):
        self.growth, self.window, self.min_steps = growth, window, min_steps
        self.history: list[float] = []
        self.suspects: list[tuple[int, float, float]] = []
        self.onset: tuple[int, float] | None = None
        self.last_stable_lr = lr0

    def update(self, rel_step: int, step: int, lr: float, loss: float, gn: float) -> bool:
        """Feed one call's metrics; True once the onset is found."""
        if not (math.isfinite(loss) and math.isfinite(gn)):
            self.onset = self.suspects[0][:2] if self.suspects else (step, lr)
            return True
        med = statistics.median(self.history[-self.window:]) if self.history else gn
        armed = rel_step > self.min_steps and len(self.history) >= 3
        if armed and gn > self.growth * max(med, 1e-12):
            self.suspects.append((step, lr, gn))
            s = self.suspects
            monotone = all(b[2] > a[2] for a, b in zip(s[-3:], s[-2:]))
            if len(s) >= 3 and monotone and s[-1][2] > 4.0 * s[-3][2]:
                self.onset = s[-3][:2]
                return True
        else:
            self.suspects.clear()
            self.last_stable_lr = lr
            self.history.append(gn)
        return False


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from pytorch_glow_tpu_torch.cli import train as train_cli

    flags = [args.profile, "--seed", str(args.seed),
             *(["--batch-size", str(args.batch_size)] if args.batch_size else []),
             *(["--data-root", args.data_root] if args.data_root
               else ["--synthetic", args.synthetic]),
             *sum((["--set", o] for o in args.overrides), [])]
    prof = train_cli.resolve_profile(train_cli.parse_args(flags))
    scratch = None
    if args.out_dir is None:  # a fresh start: no snapshot is read or kept
        scratch = tempfile.mkdtemp(prefix="lr_probe_")
    prof = prof.replace(out_dir=args.out_dir or scratch,
                        train=dataclasses.replace(prof.train, steps_per_call=1))
    try:
        return _probe(args, prof)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


def _probe(args, prof) -> dict:
    import torch

    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.builder import build, labels_to_onehot

    built = build(prof, device="cpu" if args.cpu else "cuda",
                  restore="best" if args.best else "latest")
    if args.out_dir is not None and not built.resumed:
        built.data.close()
        sys.exit(f"error: no snapshot under {args.out_dir}/{prof.name}")
    if built.resumed and not args.quiet:
        print(f"[lr_probe] probing from the step-{built.start_step} snapshot "
              f"({built.restored})", flush=True)
    g, t = prof.glow, prof.train
    k = max(1, t.grad_accum)
    start, total, spc = built.start_step, args.steps, args.spc
    tx = built.tx
    # The optimizer counts updates (one per k micro-batches); the ramp runs in them.
    tx.schedule = ramp_schedule(args.lr0, args.lr1, start // k, max(1, total // k))

    def log_lr(micro_step):
        return tx.schedule(micro_step // k)

    step_n = steplib.make_train_step_n(g, tx, spc, t.ema_decay, log_lr, t.augment_flip,
                                       built.mesh)
    state = built.state
    detector = OnsetDetector(args.lr0, args.growth, args.window, args.min_steps)
    calls = max(1, total // spc)
    try:
        for d in range(calls):
            batches = [next(built.data) for _ in range(spc)]
            x = torch.stack([b["image"] for b in batches])
            ys = [labels_to_onehot(b, prof) for b in batches]
            y = None if ys[0] is None else torch.stack(ys)
            state, metrics = step_n(state, x, y)
            gn, loss, lr = (float(metrics[key]) for key in ("grad_norm", "loss", "lr"))
            rel = (d + 1) * spc
            step = start + rel
            if not args.quiet and (d % 10 == 0 or d == calls - 1):
                print(f"[lr_probe] step {step} lr={lr:.3e} loss={loss:.4f} "
                      f"grad_norm={gn:.3f}", flush=True)
            if detector.update(rel, step, lr, loss, gn):
                break
    finally:
        built.data.close()
    onset_step, onset_lr = detector.onset or (None, None)
    out = {
        "profile": prof.name,
        "data": prof.data.name,
        "batch_size": t.batch_size,
        "grad_accum": k,
        "ramp": [args.lr0, args.lr1],
        "steps": total,
        "start_step": start,
        "onset_step": onset_step,
        "onset_lr": onset_lr,
        "max_stable_lr": detector.last_stable_lr,
        "recommended_peak": None if onset_lr is None else onset_lr / 2.0,
        "clean": onset_lr is None,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
