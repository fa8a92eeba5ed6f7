"""Train a Glow model with the PyTorch port.

Counterpart of the repository's `train.py`: a profile (JSON path or preset
name) plus data, directory and field overrides.  Runs on the card unless
`--cpu` is given.  A run resumes from the newest snapshot under
<out_dir>/<name>/checkpoints when there is one; with `--retries N`, a run
that fails rebuilds from the newest snapshot and goes on, up to N times
(N is also the step-liveness watchdog's re-exec budget).  A SIGTERM stops
the run at the next step boundary with a snapshot written and
`"preempted": true` in the printed result.

Multi-device: under `torchrun` each rank initialises the process group
(`parallel/distributed.maybe_initialize`: NCCL on the card, gloo with
`--cpu`, or `--dist-backend gloo` for ranks that share one card) and trains
on cuda:LOCAL_RANK over the profile's mesh (`--set mesh.model=2` for
tensor parallelism); rank 0 writes the files.  A multi-rank run does not
retry: a failed rank ends the launch, and a rerun resumes.

Usage:
  python -m pytorch_glow_tpu_torch.cli.train cifar10 --synthetic textured --steps 100
  python -m pytorch_glow_tpu_torch.cli.train profiles/celeba64.json --out-dir results
  python -m pytorch_glow_tpu_torch.cli.train tiny-cifar10 --cpu --synthetic \\
      --set glow.invconv_impl=pallas --set train.checkpoint_gap=10 --steps 20
  python -m pytorch_glow_tpu_torch.cli.train celeba64 --synthetic textured --retries 2
  torchrun --nproc_per_node 4 -m pytorch_glow_tpu_torch.cli.train celeba64 --synthetic textured
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

SYNTHETIC = {
    "uniform": "synthetic",
    "smooth": "synthetic_smooth",
    "textured": "synthetic_textured",
    "attr": "synthetic_attr",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("profile", help="profile JSON path or preset name "
                                   "(tiny-cifar10|cifar10|celeba64|imagenet64-cond|celebahq256)")
    p.add_argument("--data-root", default=None, help="dataset root directory")
    p.add_argument("--steps", type=int, default=None, help="override train.num_steps")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--out-dir", default=None, help="override the output directory")
    p.add_argument("--synthetic", nargs="?", const="uniform", default=None,
                   choices=sorted(SYNTHETIC),
                   help="force synthetic data (optionally pick the family)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL",
                   help="override any profile field, e.g. --set optim.lr=2e-4 "
                        "(repeatable; value parsed as JSON when possible)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--retries", type=int, default=0,
                   help="after a failure, resume from the newest snapshot, up to N times")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="under torchrun: the process group's backend (default nccl on the "
                        "card, gloo with --cpu)")
    return p.parse_args(argv)


def resolve_profile(args):
    """The profile named by `args.profile`, with the flags' overrides."""
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.utils.profiles import apply_overrides, load_profile

    if os.path.isfile(args.profile):
        prof = load_profile(args.profile)
    elif args.profile in PRESETS:
        prof = PRESETS[args.profile]
    else:
        sys.exit(f"error: profile '{args.profile}' is neither a file nor a preset "
                 f"(presets: {', '.join(PRESETS)})")

    train_over = {}
    if args.steps is not None:
        train_over["num_steps"] = args.steps
    if args.batch_size is not None:
        train_over["batch_size"] = args.batch_size
    if args.seed is not None:
        train_over["seed"] = args.seed
    if train_over:
        prof = prof.replace(train=dataclasses.replace(prof.train, **train_over))
    data_over = {}
    if args.data_root is not None:
        data_over["root"] = args.data_root
    if args.synthetic:
        data_over["name"] = SYNTHETIC[args.synthetic]
    if data_over:
        prof = prof.replace(data=dataclasses.replace(prof.data, **data_over))
    if args.out_dir is not None:
        prof = prof.replace(out_dir=args.out_dir)
    return apply_overrides(prof, args.overrides)


def main(argv=None) -> dict:
    args = parse_args(argv)
    prof = resolve_profile(args)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.parallel import distributed

    started = (not dist.is_initialized()
               and distributed.maybe_initialize(distributed.local_device(args.cpu),
                                                args.dist_backend))
    device = (distributed.local_device(args.cpu) if dist.is_initialized()
              else "cpu" if args.cpu else "cuda")
    try:
        return _run(args, prof, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, prof, device) -> dict:
    from pytorch_glow_tpu_torch.parallel import distributed
    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train

    # The step-liveness watchdog re-execs a wedged run within this budget;
    # setdefault, so a re-exec'd run keeps its decremented budget.
    os.environ.setdefault("GLOW_WEDGE_RESTART_BUDGET", str(args.retries))
    # A one-sided retry would leave the other ranks in a collective.
    attempts = args.retries + 1 if distributed.world_size() == 1 else 1
    for attempt in range(attempts):
        built = build(prof, device=device)
        if built.resumed:
            print(f"[train] resumed from step {built.start_step}")
        try:
            result = train(built, quiet=args.quiet)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # a failed run -> rebuild from the newest snapshot
            if attempt + 1 == attempts:
                raise
            print(f"[train] attempt {attempt + 1} failed ({type(e).__name__}: {e}); "
                  f"resuming from the newest snapshot", file=sys.stderr)
            continue
        print(json.dumps(result))
        return result


if __name__ == "__main__":
    main()
