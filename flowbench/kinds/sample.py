"""Closed-loop sampling: one caller asks for a batch of images at the mix's
temperature and waits until they are complete on the device; the next
call follows.

Each call draws its standard normal noise on the device from the seed and
the call's index (the top latent's, then each split's, the deepest
first), runs `models/glow.Glow.sample(n, T, noise=...)` and
`postprocess`: `inference.Inferer.sample`'s path with the draws given.
Set-up warms one call on noise no window call uses.  A sample of the
window's calls, drawn from the seed (reservoir sampling over all the
calls), keeps its images; after the window the plain reference decodes
the same noise, and the widest per-image gap, ||x - x_ref|| / ||x_ref||
over the image in [0, 1) scale before the uint8 rounding, is compared.
"""

from __future__ import annotations

import random

import torch

from flowbench import program, weights
from flowbench.counts import latent_shapes
from flowbench.faults import first_is_second, patched
from flowbench.reference import glow as ref
from pytorch_glow_tpu_torch.models.glow import Glow

CHAINS = ("reverse",)
FLOPS_FACTOR = 1
WARM_CALL = 2**40  # the noise index of the set-up call


def noise_shapes(glow: dict, n: int) -> list[tuple[int, ...]]:
    shapes = latent_shapes(glow)
    return [(n, *shapes[-1])] + [(n, h, w, c // 2) for h, w, c in reversed(shapes[:-1])]


def noise(ctx, call: int) -> list[torch.Tensor]:
    gen = weights.generator(ctx.device, ctx.seed, weights.SAMPLE_NOISE, call)
    return [torch.randn(s, generator=gen, device=ctx.device)
            for s in noise_shapes(ctx.glow, ctx.traffic["batch"])]


class Cell:
    def __init__(self, ctx):
        cfg, _, _ = program.configs(ctx.config)
        self.ctx = ctx
        self.model = program.model(cfg, weights.draw(ctx.glow, ctx.seed, ctx.device),
                                   ctx.device).eval()
        program.stamp("model")
        self.images_per_call = ctx.traffic["batch"]
        self.rng = random.Random(weights.subseed(ctx.seed, weights.SAMPLE_NOISE))
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}  # slot -> (call, images)
        self.call(WARM_CALL)
        self.kept.clear()
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)

    @torch.no_grad()
    def call(self, i: int) -> None:
        x = self.model.sample(self.images_per_call, self.ctx.traffic["temperature"],
                              noise=noise(self.ctx, i))
        self.model.postprocess(x)
        program.sync(self.ctx.device)
        if i != WARM_CALL:
            self.bad += (~torch.isfinite(x)).any()
        keep = self.ctx.traffic["checked_calls"]
        slot = i if i < keep else self.rng.randrange(i + 1)
        if slot < keep:
            self.kept[slot] = (i, x)

    def close(self):
        calls = [c for c, _ in self.kept.values()]
        x = torch.stack([x for _, x in self.kept.values()]).cpu()
        failed = int(self.bad)
        self.model = self.kept = None
        return {"calls": calls, "x": x}, failed


def reference(ctx, answers: dict, quant=None) -> dict:
    """The reference's images from the kept calls' noise."""
    P = weights.draw(ctx.glow, ctx.seed, ctx.device)
    t = ctx.traffic
    return {"x": torch.stack([ref.sample_batched(noise(ctx, c), t["temperature"], P, ctx.glow,
                                                 t["reference_rows"], quant)
                              for c in answers["calls"]]).cpu()}


def compare(answers: dict, theirs: dict) -> dict[str, float]:
    mine, want = answers["x"].double(), theirs["x"].double()
    if mine.shape != want.shape:
        return {}
    err = (mine - want).flatten(2).norm(dim=2) / want.flatten(2).norm(dim=2)
    return {"sample_gap": float(err.max())}


# The fault a sample cell can have: the first image replaced by the second
# where the program samples them.
FAULTS = {"answer_altered": lambda: patched(Glow, "sample", first_is_second)}
