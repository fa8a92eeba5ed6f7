"""The data layer's host cost per batch and the cifar10 preset's train step
with batches built on the prefetcher's thread, in worker processes, or,
with `--parent`, on the launch thread of an older checkout.

    python -m pytorch_glow_tpu_torch.scripts.perf_data [--parent DIR] [--steps 60]
        [--workers 4] [--rounds 1]

Writes a full-size CIFAR-10 python-pickle set (5 x 10000 train images and
10000 test images, textured images from the port's generator at a fixed
seed) into a temporary directory, and prints one JSON line each:

* `host_ms`: the host ms of one batch of each source, median of the
  batches after a warm-up one: textured generation at cifar10 (b=256) and
  celeba64 (b=128), the CIFAR gather (b=256);
* one line per run of `cli.train <preset> --steps N` in a subprocess
  (the cifar10 and celeba64 presets, unmodified but for
  `scalar_log_gap=10`), its median step ms from the trainer's
  metrics.csv (`scripts/run_summary.summarize_run`): arm "thread" (the
  prefetcher building batches), "workers" (`--set
  data.grain_workers=W`) and, with `--parent DIR`, "parent" (that
  checkout's cli.train, whose trainer builds each batch on the launch
  thread), on `--synthetic textured` and, for cifar10 and except the
  parent, which cannot read dataset files, on the CIFAR files.  Each
  preset's arms run in turns, parent first and last (P C C P).

The card's name and power limit (nvidia-smi) come first.  The helpers
`write_cifar10`, `write_celeba` and `write_imagenet64` also serve
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CIFAR_PER_FILE = 10000
SEED = 0


def write_cifar10(root: str, seed: int = SEED, per_file: int = CIFAR_PER_FILE) -> str:
    """CIFAR-10's python-pickle layout under `root`: data_batch_1..5 and
    test_batch of `per_file` images each, b"data" (N, 3072) CHW-flattened
    uint8 and b"labels", the images textured ones from `seed`."""
    from pytorch_glow_tpu_torch.data.synthetic import _textured_images

    os.makedirs(root, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for k, name in enumerate(names):
        rng = np.random.default_rng(np.random.SeedSequence((seed, k)))
        images = _textured_images(rng, per_file, 32, 32, 3)
        entry = {b"data": images.transpose(0, 3, 1, 2).reshape(per_file, 3072),
                 b"labels": rng.integers(0, 10, per_file).tolist()}
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(entry, f, protocol=4)
    return root


def write_imagenet64(root: str, per_file: int, size: int = 64, classes: int = 1000,
                     seed: int = SEED) -> str:
    """Downsampled ImageNet's npz layout under `root`:
    train_data_batch_1..2 and val_data.npz of `per_file` images each,
    'data' (N, size*size*3) CHW-flattened uint8 and 1-based 'labels' over
    all `classes` classes, the images textured ones from `seed` (one
    thread per file, each file from its own seed)."""
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_glow_tpu_torch.data.synthetic import _textured_images

    os.makedirs(root, exist_ok=True)
    names = ["train_data_batch_1.npz", "train_data_batch_2.npz", "val_data.npz"]

    def write(k: int) -> None:
        rng = np.random.default_rng(np.random.SeedSequence((seed, k)))
        images = _textured_images(rng, per_file, size, size, 3)
        labels = rng.permutation(np.arange(per_file) % classes) + 1
        np.savez(os.path.join(root, names[k]),
                 data=images.transpose(0, 3, 1, 2).reshape(per_file, 3 * size * size),
                 labels=labels)

    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(write, range(len(names))))
    return root


def write_celeba(root: str, n: int, test: int, seed: int = SEED) -> str:
    """A CelebA-layout folder: `img_align_celeba/` of `n` 178x218 PNGs
    (textured images, `utils.image.encode_png`), `list_attr_celeba.txt`
    with 40 ±1 attributes and `list_eval_partition.txt` with the last
    `test` images in the test split (2)."""
    from pytorch_glow_tpu_torch.data.synthetic import _textured_images
    from pytorch_glow_tpu_torch.utils.image import encode_png

    img_dir = os.path.join(root, "img_align_celeba")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"{i:06d}.png" for i in range(1, n + 1)]
    for lo in range(0, n, 100):
        for name, img in zip(names[lo:lo + 100],
                             _textured_images(rng, min(100, n - lo), 218, 178, 3)):
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(encode_png(img))
    attrs = rng.choice(np.array([-1, 1]), (n, 40))
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{n}\n" + " ".join(f"attr_{k}" for k in range(40)) + "\n")
        f.writelines(name + " " + " ".join(map(str, row)) + "\n"
                     for name, row in zip(names, attrs))
    with open(os.path.join(root, "list_eval_partition.txt"), "w") as f:
        f.writelines(f"{name} {2 if i >= n - test else 0}\n" for i, name in enumerate(names))
    return root


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def host_ms(stream, batches: int = 10) -> float:
    """Median host ms of one `next(stream)`, after a warm-up batch."""
    next(stream)
    times = []
    for _ in range(batches):
        t0 = time.perf_counter()
        next(stream)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def source_host_ms(cifar_root: str) -> dict:
    from pytorch_glow_tpu_torch.config import PRESETS, DataConfig
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.data.synthetic import synthetic_batches

    cifar, celeba = PRESETS["cifar10"], PRESETS["celeba64"]
    return {
        "textured_cifar10_b256": host_ms(synthetic_batches(
            cifar.train.batch_size, cifar.glow.image_shape, kind="textured")),
        "textured_celeba64_b128": host_ms(synthetic_batches(
            celeba.train.batch_size, celeba.glow.image_shape, kind="textured")),
        "cifar10_files_gather_b256": host_ms(make_dataset(
            DataConfig(name="cifar10", root=cifar_root), cifar.glow, cifar.train)),
    }


def run_arm(tree: str, preset: str, data: list[str], steps: int, out_dir: str,
            sets: list[str]) -> dict:
    """One `cli.train <preset>` run in a subprocess from `tree`; its median
    step ms from the trainer's metrics.csv."""
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.scripts.run_summary import summarize_run

    batch = PRESETS[preset].train.batch_size
    cmd = [sys.executable, "-m", "pytorch_glow_tpu_torch.cli.train", preset, *data,
           "--steps", str(steps), "--out-dir", out_dir, "--quiet",
           "--set", "train.scalar_log_gap=10", *sets]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} in {tree} failed:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, PRESETS[preset].name, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    summary = summarize_run(rows, batch, 10)
    return {"median_step_ms": summary["median_step_ms"], "windows": summary["step_windows"],
            "window_step_ms": [1e3 * batch / float(r["images_per_sec"]) for r in rows
                               if r.get("images_per_sec") and int(r["step"]) > 10],
            "wall_s": wall}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", default=None, help="a checkout whose trainer builds batches "
                                                  "on the launch thread")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("perf_data: needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="perf_data_")
    out = {"card": card, "arms": []}
    try:
        cifar = write_cifar10(os.path.join(tmp, "cifar"))
        out["host_ms"] = source_host_ms(cifar)
        print(json.dumps({"host_ms": out["host_ms"], "card": card}), flush=True)
        textured, files = ["--synthetic", "textured"], ["--data-root", cifar]
        workers = ["--set", f"data.grain_workers={args.workers}"]
        parent = [("parent", "textured")] if args.parent else []
        order = []
        for _ in range(args.rounds):
            arms = [("thread", "textured"), ("workers", "textured"), ("thread", "files"),
                    ("workers", "files")]
            order += [("cifar10", *a) for a in [*parent, *arms, *arms[::-1], *parent]]
            arms = arms[:2]
            order += [("celeba64", *a) for a in [*parent, *arms, *arms[::-1], *parent]]
        for i, (preset, arm, source) in enumerate(order):
            tree = os.path.abspath(args.parent) if arm == "parent" else REPO
            res = run_arm(tree, preset, textured if source == "textured" else files, args.steps,
                          os.path.join(tmp, f"run{i}"), workers if arm == "workers" else [])
            res.update(preset=preset, arm=arm, source=source, order=i, card=card)
            out["arms"].append(res)
            print(json.dumps(res), flush=True)
        medians = {}
        for r in out["arms"]:
            medians.setdefault(f"{r['preset']}/{r['arm']}/{r['source']}",
                               []).append(r["median_step_ms"])
        out["median_step_ms"] = medians
        print(json.dumps({"median_step_ms": medians, "card": card}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
