"""Builder: profile -> model, optimizer, train/eval steps and data stream.

Counterpart of `pytorch_glow_tpu/train/builder.py` `build` for one device:
the model from the profile's seed, the optimizer chain, the train step
(`steps_per_call` steps per call), the eval step, the host batch stream,
then the data-dependent actnorm init on the first batch with dequantization
noise seeded from seed + 1, and the EMA seeded from the post-DDI
parameters.  Not ported yet: device meshes, checkpoint restore (every build
starts fresh), the sample / reconstruct / SWD functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from pytorch_glow_tpu_torch.config import Profile
from pytorch_glow_tpu_torch.data.synthetic import make_dataset
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule


@dataclass
class Built:
    profile: Profile
    tx: Optimizer
    state: dict
    train_step: Callable
    eval_step: Callable
    data: Iterator
    device: torch.device
    schedule: Callable


def build(profile: Profile, device: torch.device | str = "cuda") -> Built:
    """Everything `train` needs, on `device`: the card unless the caller
    passes "cpu"."""
    g, t = profile.glow, profile.train
    device = torch.device(device)
    tx = make_optimizer(profile.optim, t)
    model = init_glow(g, torch.Generator().manual_seed(t.seed), device)
    state = steplib.init_state(model, tx, t.ema_decay, t.seed)
    schedule = make_schedule(profile.optim)
    if t.steps_per_call > 1:
        for gap_name in ("scalar_log_gap", "plot_gap", "checkpoint_gap", "eval_gap"):
            gap = getattr(t, gap_name)
            if gap % t.steps_per_call:
                raise ValueError(f"{gap_name}={gap} must be a multiple of "
                                 f"steps_per_call={t.steps_per_call}")
        train_step = steplib.make_train_step_n(g, tx, t.steps_per_call, t.ema_decay, schedule,
                                               t.augment_flip)
    else:
        train_step = steplib.make_train_step(g, tx, t.ema_decay, schedule, t.augment_flip)

    data = make_dataset(profile.data, g, t)
    first = torch.from_numpy(next(data)["image"]).to(device)
    noise = torch.Generator(device=device).manual_seed(t.seed + 1)
    model.ddi_init(model.dequantize(model.preprocess(first), noise))
    if "ema" in state:
        state["ema"] = [p.detach().clone() for _, p in steplib.trainable(model)]
    return Built(profile=profile, tx=tx, state=state, train_step=train_step,
                 eval_step=steplib.make_eval_step(g), data=data, device=device,
                 schedule=schedule)
