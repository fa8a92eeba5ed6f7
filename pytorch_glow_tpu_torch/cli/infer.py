"""Inference with the PyTorch port on a trained snapshot.

Counterpart of the repository's `infer.py`, run on the card unless `--cpu`
is given (`python -m pytorch_glow_tpu_torch.cli.infer` below):

  infer sample      <profile> -n 16 --temperature 0.7 -o s.png
  infer sample      imagenet64-cond --class-id 7 -o s.png
  infer recon       <profile> --synthetic -o recon.png
  infer nll         <profile> --synthetic --batches 8
  infer nll         <profile> --dequant-samples 4 --bound iwae
  infer delta       <profile> --data-root ... -o delta.npz [--batches 50]
  infer manipulate  <profile> --delta delta.npz --attr 31 --strength 1.5 -o manip.png
  infer interpolate <profile> --data-root ... --steps 8 -o interp.png
  infer report      <profile> --data-root ... --batches 8 -o report_dir
  infer export      <profile> -o artifact_dir [--batch-size 16|dynamic] [--keep-kernels]
  infer serve       <artifact_dir> -n 16 --temperature 0.7 -o s.png

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

`delta` writes the attribute delta (`Inferer.compute_attribute_delta`)
over `--batches` batches of a dataset with attributes (CelebA's, or
`--synthetic attr`) or class labels; `manipulate` moves `-n` images by one
attribute's delta and writes them beside the originals; `interpolate`
decodes `--steps` points between the first two images of a batch.
`report` writes to a directory (`-o`; a `.png` name becomes "report")
sample sheets over a temperature ladder, the reconstruct drift, an
interpolation, one manipulation grid per attribute (with the
`synthetic_attr` detectors' scores where the data has them), the noise-free,
1-draw ELBO and 8-draw IWAE bits/dim, and the multi-scale sliced
Wasserstein distance of `--swd-images` T=1.0 samples to the data, with
`report.json` keyed as the JAX package's.

`export` writes a serving artifact (`serve.export_artifact`: the portable
unfused path, or with `--keep-kernels` the profile's hand-written kernels)
for the device it runs on: there is no `--platforms` choice, and any other
value than that device is refused.  `serve` takes the artifact directory in
place of the profile and draws `-n` samples (a fixed-batch artifact gives
its own batch) without model code, profile or snapshot.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

OPS = ["sample", "recon", "delta", "manipulate", "interpolate", "nll", "report", "export",
       "serve"]
EXACT = {
    "glow.compute_dtype": "float32",
    "glow.flowstep_impl": "xla",
    "glow.invconv_impl": "xla",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("op", choices=OPS)
    p.add_argument("profile",
                   help="profile JSON path or preset name (op=serve: the artifact directory)")
    p.add_argument("--batch-size", default="16",
                   help="op=export: the serving batch, an int or 'dynamic' (one artifact, "
                        "any batch)")
    p.add_argument("--keep-kernels", action="store_true",
                   help="op=export: export the profile's hand-written kernels (an artifact "
                        "for the device it was exported on) instead of the portable unfused "
                        "path")
    p.add_argument("--platforms", default=None,
                   help="op=export: only the device the export runs on (cuda, or cpu with "
                        "--cpu) is accepted")
    p.add_argument("-n", "--num", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--data-root", default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="override any profile field (as the train CLI)")
    p.add_argument("--synthetic", nargs="?", const="uniform", default=None,
                   choices=["uniform", "smooth", "textured", "attr"],
                   help="force synthetic data (same families as the train CLI)")
    p.add_argument("--batches", type=int, default=50, help="batches for delta, nll and report")
    p.add_argument("--delta", default=None, help="op=manipulate: the attribute-delta .npz")
    p.add_argument("--attr", type=int, default=0, help="op=manipulate: attribute index")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=8, help="interpolation steps")
    p.add_argument("--swd-images", type=int, default=128,
                   help="op=report: images per set for the sliced-Wasserstein sample metric "
                        "(0 disables; 64 or more for a stable estimate)")
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


def _batch_size(value: str) -> int | str:
    """--batch-size: a positive int or "dynamic"."""
    if value == "dynamic":
        return value
    if not value.isdigit() or int(value) < 1:
        sys.exit(f"error: --batch-size must be a positive int or 'dynamic', got {value!r}")
    return int(value)


def serve_artifact(args) -> None:
    """infer serve: samples from an artifact directory, without model code."""
    from pytorch_glow_tpu_torch.serve import MANIFEST, load_artifact
    from pytorch_glow_tpu_torch.utils.image import save_image_grid

    if not os.path.isfile(os.path.join(args.profile, MANIFEST)):
        sys.exit(f"error: {args.profile} holds no {MANIFEST}: not a serving artifact "
                 f"(write one with `infer export`)")
    model = load_artifact(args.profile)
    n = args.num if model.batch_size == "dynamic" else None
    imgs = model.sample(seed=args.seed, temperature=args.temperature, n=n).cpu().numpy()
    save_image_grid(args.output, imgs)
    print(f"wrote {args.output} ({imgs.shape[0]} samples @ T={args.temperature} from "
          f"artifact {args.profile})")


def _pairs(images: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Originals and results interleaved, for a two-column grid."""
    return np.stack([images, out], 1).reshape(-1, *images.shape[1:])


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.op == "serve":
        serve_artifact(args)
        return
    if args.op == "export":
        batch_size = _batch_size(args.batch_size)
        here = "cpu" if args.cpu else "cuda"
        if args.platforms not in (None, here):
            sys.exit(f"error: --platforms {args.platforms}: the port exports for the device it "
                     f"runs on ({here}); export on the other device for another artifact")
    if args.op == "manipulate" and not (args.delta and os.path.isfile(args.delta)):
        sys.exit("error: --delta <file.npz> required (run `infer delta` first)")

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
        step = built.start_step
        del built
    else:
        model = init_glow(prof.glow, torch.Generator().manual_seed(prof.train.seed), device)
        snapshot = ckpt.restore(device)
        restored = snapshot is not None
        step = snapshot["step"] if restored else 0
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
    if args.op == "export":
        from pytorch_glow_tpu_torch.serve import export_artifact

        man = export_artifact(model, prof.glow, args.output, batch_size,
                              keep_kernels=args.keep_kernels)
        total = sum(f["bytes"] for f in man["functions"].values())
        print(f"wrote artifact {args.output}: {sorted(man['functions'])} b={batch_size} "
              f"device={man['device']} keep_kernels={args.keep_kernels} "
              f"({total / 1e6:.1f} MB)")
        return
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
    batch = next(data)
    if args.op == "recon":
        imgs = batch["image"][: args.num]
        rec = inferer.reconstruct(imgs).cpu().numpy()
        save_image_grid(args.output, _pairs(imgs, rec), ncol=2)
        err = np.abs(imgs.astype(np.float32) - rec.astype(np.float32)).max()
        print(f"wrote {args.output}; max |x - rec| = {err}")
        return

    if args.op == "delta":
        if "attr" not in batch and "label" not in batch:
            sys.exit("error: delta requires a dataset with attributes (CelebA, --synthetic "
                     "attr) or class labels (image_folder subdirectories)")
        delta = inferer.compute_attribute_delta(itertools.chain([batch], data), args.batches)
        Inferer.save_attribute_delta(args.output, delta)
        print(f"wrote {args.output} (delta shape {tuple(delta.shape)})")
        return

    if args.op == "manipulate":
        delta = Inferer.load_attribute_delta(args.delta)
        if not 0 <= args.attr < delta.shape[0]:
            sys.exit(f"error: --attr {args.attr} out of range [0, {delta.shape[0]})")
        imgs = batch["image"][: args.num]
        out = inferer.manipulate(imgs, delta, args.attr, args.strength).cpu().numpy()
        save_image_grid(args.output, _pairs(imgs, out), ncol=2)
        print(f"wrote {args.output} (attr {args.attr}, strength {args.strength})")
        return

    if args.op == "interpolate":
        imgs = batch["image"]
        out = inferer.interpolate(imgs[0], imgs[1], steps=args.steps).cpu().numpy()
        save_image_grid(args.output, out, ncol=args.steps)
        print(f"wrote {args.output}")
        return

    if args.op == "report":
        write_report(args, prof, inferer, batch, data, step, device)
        return

    total, count = 0.0, 0
    for bi, batch in enumerate(itertools.islice(itertools.chain([batch], data), args.batches)):
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



def write_report(args, prof, inferer, batch, data, step: int, device) -> None:
    """infer report: image sheets and report.json in one directory."""
    import torch

    from pytorch_glow_tpu_torch.inference import Inferer
    from pytorch_glow_tpu_torch.train.builder import labels_to_onehot
    from pytorch_glow_tpu_torch.train.step import step_generator
    from pytorch_glow_tpu_torch.utils.image import save_image_grid

    out_dir = args.output if not args.output.endswith(".png") else "report"
    os.makedirs(out_dir, exist_ok=True)
    model = inferer.model
    report = {
        "profile": prof.name,
        "step": int(step),
        "snapshot": "best" if args.best else "latest",
        "ema": bool(args.ema),
        "params_millions": round(sum(p.numel() for p in model.parameters()) / 1e6, 3),
        "image_shape": list(prof.glow.image_shape),
        "temperatures": [0.25, 0.5, 0.7, 1.0],
    }
    y0 = labels_to_onehot(batch, prof)
    if y0 is not None and y0.shape[0] != args.num:
        # The data batch sizes y0; -n may ask for more or fewer samples.
        y0 = y0[torch.arange(args.num) % y0.shape[0]]
    for t in report["temperatures"]:
        imgs = inferer.sample(args.num, t, step_generator(args.seed, int(t * 100), device), y0)
        save_image_grid(os.path.join(out_dir, f"samples_t{t:.2f}.png"), imgs.cpu().numpy())

    imgs = batch["image"][: args.num]
    rec = inferer.reconstruct(imgs).cpu().numpy()
    save_image_grid(os.path.join(out_dir, "recon.png"), _pairs(imgs, rec), ncol=2)
    drift = np.abs(imgs.astype(np.int16) - rec.astype(np.int16))
    report["recon_drift_u8"] = {"max": int(drift.max()), "mean": float(drift.mean()),
                                "frac_gt_1_bin": float((drift > 1).mean())}
    interp = inferer.interpolate(imgs[0], imgs[1], steps=args.steps).cpu().numpy()
    save_image_grid(os.path.join(out_dir, "interpolate.png"), interp, ncol=args.steps)

    if "attr" in batch or "label" in batch:
        # One grid per attribute (rows: images, columns: the strength
        # ladder); on synthetic_attr the closed-form detectors score the edit.
        strengths = [-1.5, -0.75, 0.0, 0.75, 1.5]
        try:
            delta = inferer.compute_attribute_delta(itertools.chain([batch], data),
                                                    args.batches)
        except ValueError as e:  # labels without a usable y_classes
            report["manipulate"] = {"error": str(e)}
            delta = None
        if delta is not None:
            Inferer.save_attribute_delta(os.path.join(out_dir, "delta.npz"), delta)
            n_show = min(4, imgs.shape[0])
            report["manipulate"] = {"strengths": strengths,
                                    "num_attributes": int(delta.shape[0])}
            detect = None
            if prof.data.name == "synthetic_attr":
                from pytorch_glow_tpu_torch.data.synth_attrs import ATTR_NAMES, measure_attributes

                detect, scores = measure_attributes, {}
            for ai in range(min(delta.shape[0], 8)):
                cols = [inferer.manipulate(imgs[:n_show], delta, ai, s).cpu().numpy()
                        for s in strengths]
                grid = np.stack(cols, 1).reshape(-1, *imgs.shape[1:])
                save_image_grid(os.path.join(out_dir, f"manipulate_attr{ai}.png"), grid,
                                ncol=len(strengths))
                if detect is not None:
                    base = detect(cols[strengths.index(0.0)])
                    scores[ATTR_NAMES[ai]] = {
                        f"{s:+.2f}": [round(float(v), 2) for v in (detect(c) - base).mean(0)]
                        for s, c in zip(strengths, cols)}
            if detect is not None:
                # scores[attr][strength]: the mean detector movement against
                # s=0 for [bright, red_tint, center_disk].
                report["manipulate"]["detector_dscore"] = scores

    sums = {"corner": 0.0, "elbo1": 0.0, "iwae8": 0.0}
    count = 0
    for bi, b in enumerate(itertools.islice(itertools.chain([batch], data), args.batches)):
        x, y = b["image"], labels_to_onehot(b, prof)
        sums["corner"] += float(inferer.nll(x, y).sum())
        sums["elbo1"] += float(inferer.nll_bound(
            x, 1, "elbo", step_generator(args.seed, bi, device), y).sum())
        sums["iwae8"] += float(inferer.nll_bound(
            x, 8, "iwae", step_generator(args.seed, bi, device), y).sum())
        count += x.shape[0]
    report["bits_dim"] = {"noise_free_corner": sums["corner"] / count,
                          "elbo_1draw": sums["elbo1"] / count,
                          "iwae_8draw": sums["iwae8"] / count, "eval_images": count}

    if args.swd_images > 0:
        # Sliced Wasserstein between the data and T=1.0 samples (the
        # density-matched temperature): whether samples match the data's
        # per-scale patch statistics.
        from pytorch_glow_tpu_torch.utils.swd import sliced_wasserstein

        reals, ylist, got = [], [], 0
        while got < args.swd_images:
            try:
                b = next(data)
            except StopIteration:
                report["swd_note"] = f"pipeline exhausted at {got}/{args.swd_images} images"
                break
            take = min(args.swd_images - got, b["image"].shape[0])
            reals.append(b["image"][:take])
            y = labels_to_onehot(b, prof)
            ylist.append(None if y is None else y[:take])
            got += take
        fakes = [inferer.sample(chunk.shape[0], 1.0,
                                step_generator(args.seed, 1000 + ci, device),
                                ylist[ci]).cpu().numpy()
                 for ci, chunk in enumerate(reals)]
        if got > 0:
            report["swd_x1e3"] = sliced_wasserstein(np.concatenate(reals),
                                                    np.concatenate(fakes), seed=args.seed)
            report["swd_x1e3"]["images_per_set"] = got

    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    swd = (f", swd {report['swd_x1e3']['swd_avg']:.1f}x1e-3" if "swd_x1e3" in report else "")
    print(f"wrote {out_dir}/report.json: step {report['step']}, elbo "
          f"{report['bits_dim']['elbo_1draw']:.4f} bits/dim (iwae8 "
          f"{report['bits_dim']['iwae_8draw']:.4f}), recon drift max "
          f"{report['recon_drift_u8']['max']} bins{swd}; "
          f"{2 + len(report['temperatures'])} image sheets")


if __name__ == "__main__":
    main()
