"""Builder: profile -> model, optimizer, train/eval steps, data stream and
checkpoints.

Counterpart of `pytorch_glow_tpu/train/builder.py` `build` for one device:
the model from the profile's seed, the optimizer chain, the train step
(`steps_per_call` steps per call), the eval step, the host batch stream and
the rolling snapshots under out_dir/name/checkpoints.  With a snapshot
there (`restore="latest"`), the model, optimizer state, EMA, step and the
stream's position come from the newest one and DDI is skipped; otherwise
the data-dependent actnorm init runs on the first batch with
dequantization noise seeded from seed + 1, and the EMA is seeded from the
post-DDI parameters.  Not ported yet: device meshes, the best snapshot
(`restore="best"` raises), the sample / reconstruct / SWD functions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from pytorch_glow_tpu_torch.config import Profile
from pytorch_glow_tpu_torch.data.synthetic import make_dataset
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager


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
    ckpt: CheckpointManager
    start_step: int = 0
    resumed: bool = False


def build(profile: Profile, device: torch.device | str = "cuda",
          restore: str = "latest") -> Built:
    """Everything `train` needs, on `device`: the card unless the caller
    passes "cpu".  `restore`: "latest" resumes from the newest snapshot
    when there is one; "best" raises (best-checkpoint tracking is not
    ported)."""
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

    ckpt = CheckpointManager(os.path.join(profile.out_dir, profile.name, "checkpoints"),
                             t.keep_checkpoints)
    if restore == "best":
        raise NotImplementedError(
            "restoring the best snapshot needs best-checkpoint tracking, which waits for "
            "held-out eval (eval_gap): not ported yet; restore the latest snapshot instead")
    if restore != "latest":
        raise ValueError(f"unknown restore: {restore!r} (latest | best)")
    data = make_dataset(profile.data, g, t)
    snapshot = ckpt.restore(device)
    if snapshot is not None:
        model.load_state_dict(snapshot["model"])
        state.update(step=snapshot["step"], seed=snapshot["seed"],
                     opt_state=snapshot["opt_state"])
        data.set_state(snapshot["data_state"])
        if "ema" in state:
            # A snapshot of a run without an EMA seeds it from the restored
            # trainables, as a fresh EMA start at this step.
            ema = snapshot["ema"]
            state["ema"] = ema if ema is not None else [
                p.detach().clone() for _, p in steplib.trainable(model)]
    else:
        first = torch.from_numpy(next(data)["image"]).to(device)
        noise = torch.Generator(device=device).manual_seed(t.seed + 1)
        model.ddi_init(model.dequantize(model.preprocess(first), noise))
        if "ema" in state:
            state["ema"] = [p.detach().clone() for _, p in steplib.trainable(model)]
    return Built(profile=profile, tx=tx, state=state, train_step=train_step,
                 eval_step=steplib.make_eval_step(g), data=data, device=device,
                 schedule=schedule, ckpt=ckpt, start_step=state["step"],
                 resumed=snapshot is not None)
