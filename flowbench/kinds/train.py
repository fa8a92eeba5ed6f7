"""Closed-loop training: the program's train step over the mix's batches.

Set-up builds one training state, the program's own: the model
(`flowbench.program.model` with the seed's weights), DDI on the first
batch (dequantized with noise from the seed), `train/step.init_state` with
the configuration's optimizer and EMA, and the step of
`train/step.make_train_step_n` fed by `data/pipeline.DevicePrefetch` over
a pool of uint8 batches made from the seed (`flowbench.images`).  It then
drives that state through the window's own call for the mix's
`followed_steps` steps, on batches that all differ, keeping each step's
loss, the first gradient as the optimizer received it (its first moment
after one step over 1 - b1) and the parameters' change after those steps,
each by leaf.  Those steps warm up every shape; the window continues from
there.

The reference (`flowbench.reference`) follows the same steps
from the same weights, batches and noise: its own DDI, f32 losses and
gradients, its own optimizer.  Compared: the largest gap of a step's loss
(bits/dim), and by the worst leaf the gap of the first gradient's norm and
of the change's norm, each over the reference's norm of that leaf or of
the median leaf, whichever is larger.  The change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone).
"""

from __future__ import annotations

import torch

from flowbench import images, program, weights
from flowbench.faults import patched
from flowbench.reference import glow as ref
from flowbench.reference.optim import Adam
from pytorch_glow_tpu_torch.data.pipeline import DevicePrefetch
from pytorch_glow_tpu_torch.models.glow import Glow
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule

CHAINS = ("forward", "backward")  # the flow-step chains a step runs
FLOPS_FACTOR = 3  # a step's operations over one forward's (recompute not counted)
STATE = 5  # the seed tag of the train state's per-step noise


class _Cycle:
    """The host's batches: the pool in turn, each as a stack of one step."""

    def __init__(self, pool):
        self.pool, self.i = pool, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.i += 1
        return {"image": self.pool[[(self.i - 1) % len(self.pool)]]}


def _by_leaf(flat: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    return torch.stack([t.norm() for t in torch.split(flat, sizes)])


class Cell:
    def __init__(self, ctx):
        t = ctx.traffic
        if t["steps_per_call"] != 1:
            raise ValueError("the train kind follows single steps: steps_per_call must be 1")
        dev = ctx.device
        self.images_per_call = t["batch"]
        cfg, ocfg, tcfg = program.configs(ctx.config)
        model = program.model(cfg, weights.draw(ctx.glow, ctx.seed, dev), dev)
        program.stamp("model")
        self.pool = images.pool(t["images"], ctx.glow["image_shape"], t["batch"], ctx.seed, dev)
        first = self.pool[0]
        model.ddi_init(model.dequantize(model.preprocess(first),
                                        noise=images.ddi_noise(first, ctx.seed, dev)))
        program.sync(dev)
        program.stamp("DDI")
        tx = make_optimizer(ocfg, tcfg)
        self.state = steplib.init_state(model, tx, tcfg.ema_decay,
                                        weights.subseed(ctx.seed, STATE))
        self.step = steplib.make_train_step_n(cfg, tx, 1, tcfg.ema_decay, make_schedule(ocfg),
                                              tcfg.augment_flip)
        self.data = DevicePrefetch(_Cycle(self.pool.cpu().numpy()), dev, t["prefetch"])
        named = steplib.trainable(model)
        sizes = [p.numel() for _, p in named]
        params = [p for _, p in named]
        start = torch.cat([p.detach().reshape(-1) for p in params])
        losses = []
        for i in range(t["followed_steps"]):
            losses.append(self._step())
            if i == 0:
                grad = _by_leaf(self.state["opt_state"]["mu"] / (1 - ocfg.betas[0]), sizes)
        with torch.no_grad():
            change = _by_leaf(torch.cat([p.reshape(-1) for p in params]) - start, sizes)
        del start
        program.stamp(f"{len(losses)} steps")
        self.answers = {"names": [n for n, _ in named], "loss": torch.stack(losses),
                        "grad": grad, "change": change}
        self.losses = []

    def _step(self) -> torch.Tensor:
        batch = next(self.data)["image"]
        self.state, m = self.step(self.state, batch)
        return m["loss"]

    def call(self, i: int) -> None:
        self.losses.append(self._step())

    def close(self):
        self.data.close()
        failed = int((~torch.isfinite(torch.stack(self.losses))).sum())
        answers = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in self.answers.items()}
        self.state = self.data = None
        return answers, failed


def reference(ctx, answers: dict, quant=None) -> dict:
    """The reference's losses, first gradient and change by leaf, over the
    same steps (`quant`: the control's rounding of the coupling nets)."""
    glow, dev, t = ctx.glow, ctx.device, ctx.traffic
    P = weights.draw(glow, ctx.seed, dev)
    pool = images.pool(t["images"], glow["image_shape"], t["batch"], ctx.seed, dev)
    n_bins = 2.0 ** glow["n_bits_x"]
    ref.ddi(ref.preprocess(pool[0], glow) + images.ddi_noise(pool[0], ctx.seed, dev) / n_bins,
            P, glow)
    names = answers["names"]
    start = {n: P[n].clone() for n in names}
    opt = Adam(ctx.config["optim"], ctx.config["train"], names, P)
    state_seed = weights.subseed(ctx.seed, STATE)
    losses = []
    for step in range(t["followed_steps"]):
        x = ref.preprocess(pool[step % len(pool)], glow)
        u = torch.rand(x.shape, generator=weights.generator(dev, state_seed, step), device=dev)
        loss, grads = ref.loss_and_grads(x + u / n_bins, P, names, glow, t["reference_rows"],
                                         quant)
        clipped = opt.step(P, grads)
        if step == 0:
            grad = torch.stack([clipped[n].norm() for n in names])
        losses.append(loss)
    change = torch.stack([(P[n] - start[n]).norm() for n in names])
    return {"loss": torch.tensor(losses), "grad": grad.cpu(), "change": change.cpu()}


def _gap(mine: torch.Tensor, theirs: torch.Tensor) -> float:
    """The worst leaf's gap of norms over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    scale = torch.clamp(theirs, min=float(theirs.median()))
    return float(((mine - theirs).abs() / scale).max())


def compare(answers: dict, theirs: dict) -> dict[str, float]:
    moved = theirs["grad"] >= 1e-3 * float(theirs["grad"].median())
    return {
        "loss_gap_bits": float((answers["loss"].double() - theirs["loss"].double()).abs().max()),
        "grad_gap": _gap(answers["grad"].double(), theirs["grad"].double()),
        "change_gap": _gap(answers["change"][moved].double(), theirs["change"][moved].double()),
    }



def _no_apply(original):
    def apply(self, params, updates):
        return None
    return apply


def _half_loss(original):
    def loss_fn(self, x, generator=None, y_onehot=None, noise=None):
        half = x.shape[0] // 2
        return original(self, x[:half], generator, y_onehot,
                        None if noise is None else noise[:half])
    return loss_fn


# The faults a train cell can have: the optimizer applies nothing, so each
# step returns the parameters as they were; the loss takes the mean over
# the first half of the batch and leaves the rest out.
FAULTS = {"state_unchanged": lambda: patched(Optimizer, "apply", _no_apply),
          "half_batch": lambda: patched(Glow, "loss_fn", _half_loss)}
