"""Move snapshots between the reference lineage (PyTorch `state_dict` files)
and the port's checkpoints.

    # a lineage .pth -> a port checkpoint that cli.train resumes and cli.infer loads
    python -m pytorch_glow_tpu_torch.scripts.torch_migrate import glow.pth celeba64 --out-dir results
    python -m pytorch_glow_tpu_torch.cli.infer sample celeba64 --out-dir results -o s.png

    # the port's weights -> a lineage .pth ({"graph": state_dict, "global_step"})
    python -m pytorch_glow_tpu_torch.scripts.torch_migrate export celeba64 --out-dir results \\
        -o glow.pth [--best] [--ema]

Counterpart of the repository's `scripts/torch_migrate.py`, on
`utils/lineage.py`.  The profile takes the train CLI's `--set` overrides.
An import lands at step 0 (`--keep-step`: the snapshot's global step) with
a fresh optimizer state and the EMA seeded from the imported weights, as
the JAX script's does; `--rename OLD=NEW` rewrites key prefixes of forks
whose names deviate.  `export` writes the newest snapshot's weights (the
best-eval one with `--best`, its EMA weights with `--ema`).  Both run on
the CPU.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("op", choices=["import", "export"])
    p.add_argument("args", nargs="+", help="import: <snapshot.pth> <profile>;  export: <profile>")
    p.add_argument("-o", "--output", default=None, help="export: the output .pth")
    p.add_argument("--out-dir", default=None, help="the profile's out_dir")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="override any profile field (as the train CLI)")
    p.add_argument("--rename", action="append", default=[], metavar="OLD=NEW",
                   help="import: a key-prefix rewrite (repeatable)")
    p.add_argument("--keep-step", action="store_true",
                   help="import: keep the snapshot's global step instead of 0")
    p.add_argument("--best", action="store_true", help="export: the best-eval snapshot")
    p.add_argument("--ema", action="store_true", help="export: the EMA weights")
    return p.parse_args(argv)


def _profile(name: str, args):
    from pytorch_glow_tpu_torch.cli import train as train_cli

    ns = argparse.Namespace(profile=name, data_root=None, steps=None, batch_size=None,
                            out_dir=args.out_dir, synthetic=None, seed=None,
                            overrides=args.overrides)
    return train_cli.resolve_profile(ns)


def _checkpoints(prof):
    import os

    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(prof.out_dir, prof.name, "checkpoints"),
                             prof.train.keep_checkpoints)


def do_import(args) -> dict:
    import torch

    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.train.optim import make_optimizer
    from pytorch_glow_tpu_torch.train.step import init_state
    from pytorch_glow_tpu_torch.utils import lineage
    from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict

    if len(args.args) != 2:
        sys.exit("usage: torch_migrate import <snapshot.pth> <profile>")
    path, name = args.args
    prof = _profile(name, args)
    t = prof.train
    sd, snap_step = lineage.load_torch_snapshot(path)
    model = init_glow(prof.glow, torch.Generator().manual_seed(t.seed), "cpu")
    rename = dict(r.split("=", 1) for r in args.rename)
    try:
        model.load_state_dict(lineage.import_state_dict(sd, model.state_dict(), rename))
    except ValueError as e:
        sys.exit(f"error: {path}: {e}")
    state = init_state(model, make_optimizer(prof.optim, t), t.ema_decay, t.seed)
    step = snap_step if args.keep_step else 0
    ckpt = _checkpoints(prof)
    latest = ckpt.latest_step()
    if latest is not None and latest > step:
        print(f"[import] warning: {ckpt.directory} already has step {latest}; a resume "
              f"restores the highest step, and the import lands at step {step}",
              file=sys.stderr)
    saved = ckpt.save(step, state, None, profile_to_dict(prof))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {path} ({len(sd)} tensors, snapshot step {snap_step}) -> {saved} "
          f"({n_params / 1e6:.2f}M params; optimizer state fresh)")
    return {"path": saved, "step": step}


def do_export(args) -> dict:
    import torch

    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.train.step import ema_params
    from pytorch_glow_tpu_torch.utils import lineage

    if len(args.args) != 1 or not args.output:
        sys.exit("usage: torch_migrate export <profile> -o out.pth")
    prof = _profile(args.args[0], args)
    ckpt = _checkpoints(prof)
    snapshot = ckpt.restore_best("cpu") if args.best else None
    if args.best and snapshot is None:
        print("[export] warning: --best: no best snapshot recorded; using the latest",
              file=sys.stderr)
    snapshot = snapshot or ckpt.restore("cpu")
    model = init_glow(prof.glow, torch.Generator().manual_seed(prof.train.seed), "cpu")
    step = 0
    if snapshot is None:
        print("[export] warning: no checkpoint found; exporting the fresh init", file=sys.stderr)
    else:
        model.load_state_dict(snapshot["model"])
        step = snapshot["step"]
        if args.ema:
            if snapshot.get("ema") is None:
                print("[export] warning: --ema requested but the snapshot has no EMA state",
                      file=sys.stderr)
            else:
                model.load_state_dict(ema_params({"model": model, "ema": snapshot["ema"]}))
    sd = lineage.export_state_dict(model.state_dict())
    lineage.save_torch_snapshot(args.output, sd, step)
    print(f"exported step-{step} weights -> {args.output} ({len(sd)} tensors, lineage naming)")
    return {"path": args.output, "step": step}


def main(argv=None) -> dict:
    args = parse_args(argv)
    return do_import(args) if args.op == "import" else do_export(args)


if __name__ == "__main__":
    main()
