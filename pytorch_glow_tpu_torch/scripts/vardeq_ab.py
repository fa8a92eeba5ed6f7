"""A/B: uniform against variational dequantization at a matched step budget.

Counterpart of `scripts/vardeq_ab.py`.  Trains two identical models (same
seeds, data stream and optimizer) that differ only in `glow.dequant`
through `build` and `train`, then scores both on held-out batches with the
bounds on the discrete NLL (`Glow.nll_bound`): the single-draw ELBO (the
published protocol) and IWAE over `--iwae-samples` draws, each batch's
draws from a generator seeded from (7, batch); and the noise-free density
at the bin corner.  The variational arm's -log q(u|x) is part of both
bounds.  Prints one JSON line per arm, then the deltas.

    python -m pytorch_glow_tpu_torch.scripts.vardeq_ab --steps 4000 --size 16
    python -m pytorch_glow_tpu_torch.scripts.vardeq_ab --cpu --steps 4 --size 8 --width 8

On the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import shutil
import sys
import tempfile

SYNTHETIC = {"uniform": "synthetic", "smooth": "synthetic_smooth",
             "textured": "synthetic_textured"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--size", type=int, default=16, help="image H = W")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--width", type=int, default=64, help="coupling hidden channels")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--L", type=int, default=2)
    p.add_argument("--vardeq-steps", type=int, default=4)
    p.add_argument("--vardeq-width", type=int, default=32)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--iwae-samples", type=int, default=8)
    p.add_argument("--synthetic", default="textured", choices=sorted(SYNTHETIC))
    p.add_argument("--out", default=None, help="runs' out_dir (default: a temporary one)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def make_profile(args, dequant: str, out_dir: str):
    from pytorch_glow_tpu_torch.config import (DataConfig, GlowConfig, OptimConfig, Profile,
                                               TrainConfig)

    return Profile(
        name=f"ab-{dequant}",
        glow=GlowConfig(image_shape=(args.size, args.size, 3), hidden_channels=args.width,
                        K=args.K, L=args.L, dequant=dequant, vardeq_steps=args.vardeq_steps,
                        vardeq_width=args.vardeq_width,
                        vardeq_context_width=args.vardeq_width // 2),
        optim=OptimConfig(lr=5e-4, warmup_steps=200, schedule="noam"),
        train=TrainConfig(batch_size=args.batch_size, num_steps=args.steps,
                          scalar_log_gap=max(1, args.steps // 20), plot_gap=0,
                          checkpoint_gap=0, eval_gap=0, num_sample_images=4, seed=0,
                          step_timeout_s=0.0),
        data=DataConfig(name=SYNTHETIC[args.synthetic], image_size=args.size),
        out_dir=out_dir,
    )


def score(model, data, args, device) -> dict:
    """The mean ELBO, IWAE and bin-corner bits/dim over the eval batches."""
    import torch

    sums = {"elbo": 0.0, "iwae": 0.0, "corner": 0.0}
    count = 0
    with torch.no_grad():
        for i, batch in enumerate(itertools.islice(data, args.eval_batches)):
            x = model.preprocess(torch.as_tensor(batch["image"]).to(device))

            def gen():
                return torch.Generator(device=device).manual_seed(7 * 1_000_003 + i)

            sums["elbo"] += float(model.nll_bound(x, gen(), 1, "elbo").sum())
            sums["iwae"] += float(model.nll_bound(x, gen(), args.iwae_samples, "iwae").sum())
            sums["corner"] += float(model.log_prob(x)["nll"].sum())
            count += x.shape[0]
    return {k: v / max(1, count) for k, v in sums.items()} | {"count": count}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train

    device = "cpu" if args.cpu else "cuda"
    out_dir = args.out or tempfile.mkdtemp(prefix="vardeq_ab_")
    results = {}
    try:
        for dequant in ("uniform", "variational"):
            prof = make_profile(args, dequant, out_dir)
            built = build(prof, device=device)
            r = train(built, quiet=True)
            s = score(built.state["model"], make_dataset(prof.data, prof.glow, prof.train,
                                                         split="test"), args, device)
            results[dequant] = {
                "dequant": dequant,
                "train_loss_final": r["loss"],
                "elbo_bits_dim": s["elbo"],
                f"iwae{args.iwae_samples}_bits_dim": s["iwae"],
                "corner_bits_dim": s["corner"],
                "eval_images": s["count"],
                "steps": r["final_step"],
                "wall_s": r["wall_s"],
            }
            print(json.dumps(results[dequant]), flush=True)
    finally:
        if args.out is None:
            shutil.rmtree(out_dir, ignore_errors=True)
    u, v = results["uniform"], results["variational"]
    iw = f"iwae{args.iwae_samples}_bits_dim"
    summary = {"delta_elbo_bits_dim": u["elbo_bits_dim"] - v["elbo_bits_dim"],
               f"delta_{iw}": u[iw] - v[iw], "positive_means_variational_wins": True,
               "synthetic": args.synthetic, "size": args.size, "steps": args.steps,
               "device": device}
    print(json.dumps(summary), flush=True)
    return {"arms": results, "summary": summary}


if __name__ == "__main__":
    main()
