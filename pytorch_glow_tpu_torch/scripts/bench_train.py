"""In-process A/B of the whole train step: the fused flow step (K1 forward,
K3 backward; K4 / K5 on band levels) against the unfused layers.

    python -m pytorch_glow_tpu_torch.scripts.bench_train
    AB_PRESET=cifar10 AB_SPC=2 python -m pytorch_glow_tpu_torch.scripts.bench_train
    python -m pytorch_glow_tpu_torch.scripts.bench_train --cpu --set glow.hidden_channels=8 \\
        --set glow.K=2 --set train.batch_size=2

Counterpart of the JAX package's `scripts/bench_train.py`.  Host-bound
steps move between processes, so both impls run in one process, one after
the other.  Per impl: a seeded state (`init_glow` from seed 0, the
profile's optimizer, no EMA), DDI on a dequantized uint8 batch (seeds 1
and 2); `train/step.make_train_step_n(cfg, tx, spc)`, spc steps a call
over stacked uint8 batches (seed 3; labels from seed 4 on a conditional
profile); the first call, which builds the kernels, timed as `compile_s`;
then two-N differencing over 2 and 6 calls, each count synced on its last
loss, per step = (t6 - t2) / (4 * spc).  Prints one JSON line per impl,
with the JAX script's keys: impl ("pallas" fused, "xla" unfused), remat,
train_images_per_sec, ms_per_step, compile_s, loss0 (the first call's
last loss), loss, grad_norm, raw_wall_s ([t2, t6]); unrounded.

Knobs: the preset as an argument, else AB_PRESET (celeba64); AB_SPC (5),
AB_IMPLS (pallas,xla), AB_BATCH (the preset's), AB_XLA_REMAT (1 at
celeba64, else 0: the unfused celeba64 step at b=128 without remat is the
JAX script's reason; celebahq256's at b=64 needs 1 to fit too),
AB_PALLAS_REMAT (unset: the preset's).  Runs on the
card; `--cpu` runs on CPU tensors (the plain versions), for the tests.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from pytorch_glow_tpu_torch.config import PRESETS
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.scripts import _anatomy as A
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.optim import make_optimizer
from pytorch_glow_tpu_torch.utils.profiles import apply_overrides

N1, N2 = 2, 6


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("profile", nargs="?", default=None, help="preset name (AB_PRESET)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="profile overrides")
    p.add_argument("--cpu", action="store_true", help="run on CPU tensors")
    return p.parse_args(argv)


def impl_cfg(prof, impl: str, remat: bool | None = None):
    """The profile's GlowConfig with `flowstep_impl=impl` and `remat`
    (None: the profile's)."""
    return dataclasses.replace(prof.glow, flowstep_impl=impl,
                               remat=prof.glow.remat if remat is None else remat)


def seeded_state(cfg, prof, b: int, device) -> dict:
    """The JAX script's start: weights from seed 0, the optimizer's state,
    DDI on a uint8 batch from seed 1 dequantized with seed 2."""
    h, w, c = cfg.image_shape
    model = init_glow(cfg, torch.Generator().manual_seed(0), device)
    state = steplib.init_state(model, make_optimizer(prof.optim, prof.train))
    x_u8 = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(device)
    noise = torch.rand((b, h, w, c), generator=torch.Generator().manual_seed(2)).to(device)
    model.ddi_init(model.dequantize(model.preprocess(x_u8), noise=noise))
    return state


def seeded_batches(cfg, spc: int, b: int, device):
    """(spc, b, H, W, C) uint8 batches from seed 3, and one-hot labels from
    seed 4 on a conditional profile (else None)."""
    h, w, c = cfg.image_shape
    batches = torch.randint(0, 256, (spc, b, h, w, c), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(3)).to(device)
    y = None
    if cfg.y_condition:
        labels = torch.randint(0, cfg.y_classes, (spc, b),
                               generator=torch.Generator().manual_seed(4))
        y = torch.nn.functional.one_hot(labels, cfg.y_classes).float().to(device)
    return batches, y


def run(prof, impl: str, spc: int, remat: bool | None = None, batch: int | None = None,
        device="cuda", state: dict | None = None, batches=None, y=None,
        n: tuple[int, int] = (N1, N2)) -> dict:
    """One impl's line.  `state` and `batches` (with `y`) default to the
    seeded ones; a caller passes its own to hold the first call's loss
    against another implementation's from the same start.  A given state
    is trained in place, and its model's config must be this impl's."""
    device = torch.device(device)
    cfg = impl_cfg(prof, impl, remat)
    b = batch or prof.train.batch_size
    if state is None:
        state = seeded_state(cfg, prof, b, device)
    if batches is None:
        batches, y = seeded_batches(cfg, spc, b, device)
    tx = make_optimizer(prof.optim, prof.train)
    step_n = steplib.make_train_step_n(cfg, tx, spc)

    t0 = time.perf_counter()
    state, metrics = step_n(state, batches, y)
    loss0 = float(metrics["loss"])  # syncs
    compile_s = time.perf_counter() - t0

    def reps_time(count: int):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(count):
            state, metrics = step_n(state, batches, y)
        float(metrics["loss"])
        return time.perf_counter() - t0, metrics

    n1, n2 = n
    t1, _ = reps_time(n1)
    t2, metrics = reps_time(n2)
    per_step = (t2 - t1) / ((n2 - n1) * spc)
    return {
        "impl": impl,
        "remat": cfg.remat,
        "train_images_per_sec": b / per_step,
        "ms_per_step": 1000 * per_step,
        "compile_s": compile_s,
        "loss0": loss0,
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "raw_wall_s": [t1, t2],
    }


def main(argv=None, n: tuple[int, int] = (N1, N2)) -> list[dict]:
    """The module docstring's lines; `n`, the two call counts of two-N
    differencing, is cut by `chip_smoke.py`, whose time is limited."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    preset = args.profile or os.environ.get("AB_PRESET", "celeba64")
    spc = int(os.environ.get("AB_SPC", "5"))
    impls = os.environ.get("AB_IMPLS", "pallas,xla").split(",")
    xla_remat = os.environ.get("AB_XLA_REMAT", "1" if preset == "celeba64" else "0")
    pallas_remat = os.environ.get("AB_PALLAS_REMAT")  # unset = the preset's
    prof = apply_overrides(PRESETS[preset], args.overrides)
    b = int(os.environ.get("AB_BATCH", prof.train.batch_size))
    device = "cpu" if args.cpu else "cuda"
    print(f"card: {'cpu' if args.cpu else A.card()}", flush=True)
    print(f"# train-step A/B: {preset} b={b} spc={spc} on "
          f"{'cpu' if args.cpu else torch.cuda.get_device_name(0)}", flush=True)
    rows = []
    for impl in impls:
        if impl == "xla":
            remat = bool(int(xla_remat))
        else:
            remat = None if pallas_remat is None else bool(int(pallas_remat))
        rows.append(run(prof, impl, spc, remat, b, device, n=n))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
