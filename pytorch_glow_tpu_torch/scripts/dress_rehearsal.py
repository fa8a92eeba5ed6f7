"""Dress rehearsal: the whole real-data chain in one command, each stage a
subprocess of the port's own CLIs, as a user would run them.

Counterpart of `scripts/dress_rehearsal.py`.  TensorFlow is not needed:
the fixtures are CIFAR-10 python pickles written here (textured images),
turned into tfds-style TFRecord shards by the port's writer, and the
training stream reads those shards in worker processes (the port's
counterpart of the JAX rehearsal's Grain route).

  1. prepare   `scripts.prepare_tfrecords cifar10` writes train/test shards
  2. train     `cli.train <profile> --data-root <shards>` with
               `data.grain_workers=2` and an eval boundary, so a best
               snapshot and best.json exist
  3. resume    the same command with more steps resumes, not restarts
  4. report    `cli.infer report --best` on the held-out shard
  5. export    `cli.infer export` (weights baked in)
  6. serve     `cli.infer serve <artifact>` samples with no model code

Prints one JSON line {"dress_rehearsal": "OK", ...}; a failing stage exits
2 with its stderr.  On the card unless `--cpu` is given.

    python -m pytorch_glow_tpu_torch.scripts.dress_rehearsal [--out DIR] [--steps 40] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = 32  # CIFAR-10 geometry
PER_FILE = 64  # images in each of the five train pickles and the test pickle


def run(stage: str, args: list[str], seconds: dict, timeout: int = 900) -> str:
    """`python -m <args>` from the repository root; its stdout, or exit 2.
    Adds the stage's wall seconds to `seconds`."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)}
    r = subprocess.run([sys.executable, "-u", "-m", *args], capture_output=True, text=True,
                       timeout=timeout, cwd=REPO, env=env)
    if r.returncode != 0:
        print(f"[dress_rehearsal] stage '{stage}' FAILED rc={r.returncode}\n"
              f"--- cmd: {' '.join(args)}\n--- stderr:\n{r.stderr[-4000:]}", file=sys.stderr)
        raise SystemExit(2)
    seconds[stage] = round(time.perf_counter() - t0, 2)
    return r.stdout


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--cpu", action="store_true", help="every stage on the CPU")
    ap.add_argument("--keep", action="store_true", help="keep the work directory")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from pytorch_glow_tpu_torch.config import (DataConfig, GlowConfig, Profile, TrainConfig)
    from pytorch_glow_tpu_torch.scripts.perf_data import write_cifar10
    from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict

    work = args.out or tempfile.mkdtemp(prefix="dress_rehearsal_")
    os.makedirs(work, exist_ok=True)
    cpu = ["--cpu"] if args.cpu else []
    summary: dict = {"work_dir": work, "device": "cpu" if args.cpu else "cuda", "stage_s": {}}
    secs = summary["stage_s"]
    try:
        pickles, shards = os.path.join(work, "cifar10"), os.path.join(work, "tfds")
        write_cifar10(pickles, per_file=PER_FILE)
        run("prepare", ["pytorch_glow_tpu_torch.scripts.prepare_tfrecords", "cifar10", pickles,
                        shards, "--shards", "2"], secs)
        summary["fixtures"] = sorted(os.listdir(shards))

        gap = max(args.steps // 2, 1)
        prof = Profile(
            name="rehearsal",
            glow=GlowConfig(image_shape=(SIZE, SIZE, 3), hidden_channels=32, K=2, L=2),
            train=TrainConfig(batch_size=16, num_steps=args.steps, scalar_log_gap=gap,
                              plot_gap=0, checkpoint_gap=gap, eval_gap=gap, eval_batches=2,
                              num_sample_images=4, step_timeout_s=0.0),
            data=DataConfig(name="cifar10", root=shards, grain_workers=2),
            out_dir=os.path.join(work, "results"))
        prof_path = os.path.join(work, "rehearsal.json")
        with open(prof_path, "w") as f:
            json.dump(profile_to_dict(prof), f)

        out = run("train", ["pytorch_glow_tpu_torch.cli.train", prof_path, *cpu, "--quiet"], secs)
        assert f'"final_step": {args.steps}' in out, out[-2000:]
        out = run("resume", ["pytorch_glow_tpu_torch.cli.train", prof_path, *cpu, "--quiet",
                             "--steps", str(args.steps + gap)], secs)
        assert "resumed from step" in out and f'"final_step": {args.steps + gap}' in out, \
            out[-2000:]
        with open(os.path.join(prof.out_dir, prof.name, "checkpoints-best", "best.json")) as f:
            summary["best"] = json.load(f)

        rep = os.path.join(work, "report")
        run("report", ["pytorch_glow_tpu_torch.cli.infer", "report", prof_path, *cpu, "--best",
                       "--batches", "2", "-n", "4", "--swd-images", "32", "-o", rep], secs)
        with open(os.path.join(rep, "report.json")) as f:
            report = json.load(f)
        bd = report["bits_dim"]["elbo_1draw"]
        assert 0.0 < bd < 8.1, f"implausible bits/dim {bd}"
        summary["report_bits_dim_elbo"] = round(bd, 4)
        summary["report_snapshot_step"] = report["step"]

        art = os.path.join(work, "artifact")
        run("export", ["pytorch_glow_tpu_torch.cli.infer", "export", prof_path, *cpu,
                       "--batch-size", "4", "-o", art], secs)
        served = os.path.join(work, "served.png")
        run("serve", ["pytorch_glow_tpu_torch.cli.infer", "serve", art, "--temperature", "0.7",
                      "-o", served], secs)
        summary["served_png_bytes"] = os.path.getsize(served)
        assert summary["served_png_bytes"] > 0
        summary["dress_rehearsal"] = "OK"
        print(json.dumps(summary))
        return summary
    finally:
        if not args.keep and args.out is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
