"""Inference with the PyTorch port on a trained snapshot.

Counterpart of the repository's `infer.py` for three operations, run on the
card unless `--cpu` is given:

  python -m pytorch_glow_tpu_torch.cli.infer sample <profile> -n 16 --temperature 0.7 -o s.png
  python -m pytorch_glow_tpu_torch.cli.infer sample imagenet64-cond --class-id 7 -o s.png
  python -m pytorch_glow_tpu_torch.cli.infer recon  <profile> --synthetic -o recon.png
  python -m pytorch_glow_tpu_torch.cli.infer nll    <profile> --synthetic --batches 8
  python -m pytorch_glow_tpu_torch.cli.infer nll    <profile> --dequant-samples 4 --bound iwae

The profile (JSON path or preset, with the same `--set` overrides as the
train CLI) locates the newest snapshot under <out_dir>/<name>/checkpoints;
`--best` loads the best-eval one instead (through `build(restore="best")`:
with no best recorded, the newest, with a warning; with no snapshot at
all, an error).  `--exact` runs the f32 unfused path (no fused flow step,
no 1x1 conv kernels) on the same parameters.

On a y-conditional profile, `sample --class-id N` draws class N (it
needs one), and `nll` scores each batch under its own labels.
`nll --dequant-samples N` reports the Monte-Carlo bound on the discrete
NLL over N dequantization draws per image, the mean of the per-draw
bounds (`--bound elbo`) or the importance bound (`iwae`); batch i draws
from a generator seeded from (`--seed`, i).

Not ported yet, each exiting with an error: delta, manipulate,
interpolate, report, export and serve.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

NOT_PORTED = {
    "delta": "the attribute-delta estimate",
    "manipulate": "attribute manipulation",
    "interpolate": "latent interpolation",
    "report": "the quality report",
    "export": "the serving-artifact export",
    "serve": "serving an exported artifact",
}
EXACT = {
    "glow.compute_dtype": "float32",
    "glow.flowstep_impl": "xla",
    "glow.invconv_impl": "xla",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("op", choices=["sample", "recon", "nll", *NOT_PORTED])
    p.add_argument("profile", help="profile JSON path or preset name")
    p.add_argument("-n", "--num", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--data-root", default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="override any profile field (as the train CLI)")
    p.add_argument("--synthetic", nargs="?", const="uniform", default=None,
                   choices=["uniform", "smooth", "textured", "attr"],
                   help="force synthetic data (same families as the train CLI)")
    p.add_argument("--batches", type=int, default=50, help="batches for nll")
    p.add_argument("--dequant-samples", type=int, default=0,
                   help="op=nll: the valid discrete-NLL bound over N dequantization-noise "
                        "draws (0 = the noise-free eval at the bin corner; 1 = the "
                        "published protocol)")
    p.add_argument("--bound", choices=["elbo", "iwae"], default="elbo",
                   help="op=nll with --dequant-samples N: the mean of the per-draw bounds "
                        "(elbo) or the tighter logsumexp importance bound (iwae)")
    p.add_argument("--class-id", type=int, default=None,
                   help="op=sample on a y-conditional profile: sample this class")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exact", action="store_true",
                   help="f32 unfused inference whatever the profile's bf16 / kernel settings")
    p.add_argument("--ema", action="store_true",
                   help="use the snapshot's EMA parameters if it has them")
    p.add_argument("--best", action="store_true",
                   help="load the best-eval snapshot (lowest held-out bits/dim)")
    p.add_argument("--out-dir", default=None, help="training out-dir (to locate snapshots)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("-o", "--output", default="infer_out.png")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.op in NOT_PORTED:
        sys.exit(f"error: infer {args.op} ({NOT_PORTED[args.op]}) is not ported yet")

    import torch

    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.inference import Inferer
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.train.builder import build, labels_to_onehot
    from pytorch_glow_tpu_torch.train.step import ema_params, step_generator
    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
    from pytorch_glow_tpu_torch.utils.image import save_image_grid

    overrides = list(args.overrides)
    if args.exact:
        # Parameters are stored in f32 whatever the compute settings, so the
        # exact path is an inference-time choice; every knob that changes
        # precision or routes through a kernel is forced.
        for ov in overrides:
            key = ov.split("=", 1)[0].strip()
            if key in EXACT:
                print(f"[infer] warning: --exact overrides your --set {ov!r} with "
                      f"{key}={EXACT[key]}", file=sys.stderr)
        overrides += [f"{k}={v}" for k, v in EXACT.items()]
    ns = argparse.Namespace(profile=args.profile, data_root=args.data_root, steps=None,
                            batch_size=None, out_dir=args.out_dir, synthetic=args.synthetic,
                            seed=None, overrides=overrides)
    prof = train_cli.resolve_profile(ns)
    g = prof.glow
    if args.op == "sample" and g.y_condition and args.class_id is None:
        # The JAX CLI stops too, at the model's assertion.
        sys.exit("error: sampling a y-conditional profile needs --class-id")
    if args.op == "sample" and args.class_id is not None:
        if not g.y_condition:
            sys.exit("error: --class-id requires a y-conditional profile")
        if not 0 <= args.class_id < g.y_classes:
            sys.exit(f"error: --class-id {args.class_id} out of range [0, {g.y_classes})")
    device = torch.device("cpu" if args.cpu else "cuda")
    run_dir = os.path.join(prof.out_dir, prof.name)
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    if args.best:
        # A fresh init is never anyone's best snapshot.
        if ckpt.best_info() is None and ckpt.latest_step() is None:
            sys.exit(f"error: --best requested but no checkpoint found under {run_dir}")
        built = build(prof, device, restore="best")
        if built.restored is None:
            sys.exit(f"error: --best requested but no checkpoint found under {run_dir}")
        if built.restored != "best":
            print(f"[infer] warning: --best: no best snapshot recorded under {run_dir}; "
                  f"using the latest (step {built.start_step})", file=sys.stderr)
        print(f"[infer] loaded the {built.restored} snapshot, step {built.start_step}")
        model, ema, restored = built.state["model"], built.state.get("ema"), True
        del built
    else:
        model = init_glow(prof.glow, torch.Generator().manual_seed(prof.train.seed), device)
        snapshot = ckpt.restore(device)
        restored = snapshot is not None
        if restored:
            model.load_state_dict(snapshot["model"])
            ema = snapshot["ema"]
    if not restored:
        print("[infer] warning: no checkpoint found — using fresh (DDI-less) params",
              file=sys.stderr)
    elif args.ema:
        if ema is not None:
            model.load_state_dict(ema_params({"model": model, "ema": ema}))
        else:
            print("[infer] warning: --ema requested but snapshot has no EMA state",
                  file=sys.stderr)
    inferer = Inferer(model)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    if args.op == "sample":
        y = None
        if g.y_condition:
            y = torch.zeros(args.num, g.y_classes)
            y[:, args.class_id] = 1.0
        imgs = inferer.sample(args.num, args.temperature, gen, y).cpu().numpy()
        save_image_grid(args.output, imgs)
        cls = f", class {args.class_id}" if args.class_id is not None else ""
        print(f"wrote {args.output} ({args.num} samples @ T={args.temperature}{cls})")
        return

    data = make_dataset(prof.data, prof.glow, prof.train)
    if args.op == "recon":
        imgs = next(data)["image"][: args.num]
        rec = inferer.reconstruct(imgs).cpu().numpy()
        interleaved = np.stack([imgs, rec], 1).reshape(-1, *imgs.shape[1:])
        save_image_grid(args.output, interleaved, ncol=2)
        err = np.abs(imgs.astype(np.float32) - rec.astype(np.float32)).max()
        print(f"wrote {args.output}; max |x - rec| = {err}")
        return

    total, count = 0.0, 0
    for bi, batch in enumerate(itertools.islice(data, args.batches)):
        y = labels_to_onehot(batch, prof)  # the prior's shift on a y-conditional profile
        if args.dequant_samples > 0:
            nll = inferer.nll_bound(batch["image"], args.dequant_samples, args.bound,
                                    step_generator(args.seed, bi, device), y)
        else:
            nll = inferer.nll(batch["image"], y)
        total += float(nll.sum())
        count += nll.shape[0]
    how = (f"{args.bound} bound, {args.dequant_samples} noise draws"
           if args.dequant_samples > 0 else "noise-free (bin corner)")
    print(f"nll: {total / count:.4f} bits/dim over {count} images ({how})")


if __name__ == "__main__":
    main()
