"""The preset's optimizer chain in plain PyTorch, by leaf: each gradient
clipped to [-max_grad_clip, max_grad_clip], then all of them scaled down
together where their global norm passes max_grad_norm, then Adam with bias
correction, scaled by the learning rate at the step count before the
update: linear warm-up, noam (lr sqrt(w) min(s^-1/2, s w^-3/2), s = count
+ 1) or constant.  A step whose gradient is not finite updates nothing
(apply-if-finite)."""

from __future__ import annotations

import math

import torch


def learning_rate(optim: dict, count: int) -> float:
    lr, w = optim["lr"], float(optim["warmup_steps"])
    if optim["schedule"] == "constant":
        return lr
    if optim["schedule"] == "warmup":
        return lr * min(1.0, (count + 1.0) / max(1.0, w))
    if optim["schedule"] == "noam":
        s = count + 1.0
        return lr * math.sqrt(w) * min(s ** -0.5, s * w ** -1.5)
    raise ValueError(f"unknown schedule: {optim['schedule']}")


class Adam:
    """State by leaf name; `step` updates the given leaves in place and
    returns the clipped gradients, as the first moment receives them."""

    def __init__(self, optim: dict, train: dict, names: list[str], like: dict):
        if optim["name"] != "adam":
            raise ValueError(f"the reference has Adam only, not {optim['name']}")
        self.optim, self.train, self.count = optim, train, 0
        self.mu = {n: torch.zeros_like(like[n]) for n in names}
        self.nu = {n: torch.zeros_like(like[n]) for n in names}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict[str, torch.Tensor]:
        clip, max_norm = self.train["max_grad_clip"], self.train["max_grad_norm"]
        g = {n: t.clamp(-clip, clip) if clip > 0 else t for n, t in grads.items()}
        if not all(bool(torch.isfinite(t).all()) for t in g.values()):
            return g
        if max_norm > 0:
            norm = torch.sqrt(sum(torch.square(t).sum() for t in g.values()))
            if norm >= max_norm:
                g = {n: t / norm * max_norm for n, t in g.items()}
        b1, b2 = self.optim["betas"]
        lr = learning_rate(self.optim, self.count)
        self.count += 1
        for n, t in g.items():
            self.mu[n] = (1 - b1) * t + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * t * t + b2 * self.nu[n]
            mu_hat = self.mu[n] / (1 - b1 ** self.count)
            nu_hat = self.nu[n] / (1 - b2 ** self.count)
            params[n] += -lr * mu_hat / (torch.sqrt(nu_hat) + self.optim["eps"])
        return g
