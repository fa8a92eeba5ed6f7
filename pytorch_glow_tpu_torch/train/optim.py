"""Optimizer chain and learning-rate schedules, with optax's semantics.

Counterpart of `pytorch_glow_tpu/train/optim.py` (`make_schedule`,
`make_optimizer`).  The chain is the same, innermost first:

    clip(max_grad_clip) -> clip_by_global_norm(max_grad_norm)
      -> Adam or Adamax, scaled by -schedule(count) at the optimizer's count
    MultiSteps(grad_accum) around it when grad_accum > 1
    apply_if_finite(skip_nonfinite_updates) outermost, so a skipped step
      leaves all inner state alone, the count and the accumulator included

It works on one flat f32 vector holding every trainable parameter, so each
stage is a handful of tensor ops whatever the number of parameters, and the
branches of the optax wrappers become `torch.where` selections on the
device: no step waits on the host.  A parameter that receives no gradient
counts as a zero gradient, as it does under `jax.grad`.

`Optimizer.global_norm` (flat gradient -> its l2 norm) serves the
global-norm clip and the step's `grad_norm`; under tensor parallelism the
builder sets it to `parallel/mesh.global_norm_fn`, the norm over every
rank's shards.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_glow_tpu_torch.config import OptimConfig, TrainConfig

Schedule = Callable[[torch.Tensor], torch.Tensor]
State = dict[str, torch.Tensor]

_INNER = ("count", "mu", "nu")
_MULTI = ("mini_step", "gradient_step", "acc")


def make_schedule(cfg: OptimConfig) -> Schedule:
    """count (int tensor) -> learning rate (f32 tensor on its device)."""
    if cfg.schedule == "constant":
        return lambda count: torch.full((), cfg.lr, dtype=torch.float32, device=count.device)
    if cfg.schedule == "warmup":
        # Linear ramp to lr over warmup_steps, then constant.
        def warmup(count):
            ramp = (count.float() + 1.0) / max(1, cfg.warmup_steps)
            return cfg.lr * torch.clamp(ramp, max=1.0)

        return warmup
    if cfg.schedule == "noam":
        w = float(cfg.warmup_steps)

        def noam(count):
            s = count.float() + 1.0
            return cfg.lr * (w**0.5) * torch.minimum(s**-0.5, s * w**-1.5)

        return noam
    raise ValueError(f"unknown schedule: {cfg.schedule}")


def _select(cond: torch.Tensor, new: State, old: State, keys) -> State:
    return {k: torch.where(cond, new[k], old[k]) for k in keys}


class Optimizer:
    """The optax chain of `make_optimizer` over a flat parameter vector.

    `init(params)` -> state; `update(grads, state)` -> (updates, state) on
    flat vectors; `flatten` and `apply` map to and from the parameters."""

    def __init__(self, opt_cfg: OptimConfig, train_cfg: TrainConfig):
        if opt_cfg.name not in ("adam", "adamax"):
            raise ValueError(f"unknown optimizer: {opt_cfg.name}")
        self.schedule = make_schedule(opt_cfg)
        self.adamax = opt_cfg.name == "adamax"
        self.b1, self.b2 = opt_cfg.betas
        self.eps = opt_cfg.eps
        self.max_grad_clip = train_cfg.max_grad_clip or 0.0
        self.max_grad_norm = train_cfg.max_grad_norm or 0.0
        self.grad_accum = max(1, train_cfg.grad_accum)
        self.max_errors = train_cfg.skip_nonfinite_updates or 0
        self.global_norm: Callable[[torch.Tensor], torch.Tensor] = torch.linalg.vector_norm

    def init(self, params: list[torch.Tensor]) -> State:
        n = sum(p.numel() for p in params)
        dev = params[0].device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = {"count": zeros(dtype=torch.int32), "mu": zeros(n), "nu": zeros(n)}
        if self.grad_accum > 1:
            state.update(mini_step=zeros(dtype=torch.int32),
                         gradient_step=zeros(dtype=torch.int32), acc=zeros(n))
        if self.max_errors > 0:
            state.update(notfinite_count=zeros(dtype=torch.int32),
                         last_finite=torch.ones((), dtype=torch.bool, device=dev),
                         total_notfinite=zeros(dtype=torch.int32))
        return state

    def _inner(self, g: torch.Tensor, st: State) -> tuple[torch.Tensor, State]:
        if self.max_grad_clip > 0:
            g = g.clamp(-self.max_grad_clip, self.max_grad_clip)
        if self.max_grad_norm > 0:
            norm = self.global_norm(g)
            g = torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
        count_inc = st["count"] + 1
        mu = (1 - self.b1) * g + self.b1 * st["mu"]
        mu_hat = mu / (1 - torch.pow(self.b1, count_inc))
        if self.adamax:
            nu = torch.maximum(g.abs() + self.eps, self.b2 * st["nu"])
            upd = mu_hat / nu
        else:
            nu = (1 - self.b2) * g**2 + self.b2 * st["nu"]
            nu_hat = nu / (1 - torch.pow(self.b2, count_inc))
            upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        upd = -self.schedule(st["count"]) * upd
        return upd, {"count": count_inc, "mu": mu, "nu": nu}

    def _accumulated(self, g: torch.Tensor, st: State) -> tuple[torch.Tensor, State]:
        """optax.MultiSteps: the running mean of the micro-batch grads; the
        inner update is emitted, and its state kept, on the last one."""
        if self.grad_accum == 1:
            return self._inner(g, st)
        acc = st["acc"] + (g - st["acc"]) / (st["mini_step"] + 1)
        upd, inner = self._inner(acc, st)
        emit = st["mini_step"] == self.grad_accum - 1
        new = _select(emit, inner, st, _INNER)
        new["mini_step"] = (st["mini_step"] + 1) % self.grad_accum
        new["gradient_step"] = torch.where(emit, st["gradient_step"] + 1, st["gradient_step"])
        new["acc"] = torch.where(emit, torch.zeros_like(acc), acc)
        return torch.where(emit, upd, torch.zeros_like(upd)), new

    def update(self, g: torch.Tensor, st: State) -> tuple[torch.Tensor, State]:
        if self.max_errors <= 0:
            return self._accumulated(g, st)
        # optax.apply_if_finite: reject (zero update, inner state untouched)
        # unless finite or past max_consecutive_errors.
        finite = torch.isfinite(g).all()
        notfinite = torch.where(finite, torch.zeros_like(st["notfinite_count"]),
                                st["notfinite_count"] + 1)
        accept = finite | (notfinite > self.max_errors)
        upd, inner = self._accumulated(g, st)
        keys = _INNER + (_MULTI if self.grad_accum > 1 else ())
        new = _select(accept, inner, st, keys)
        new["notfinite_count"] = notfinite
        new["last_finite"] = finite
        new["total_notfinite"] = torch.where(finite, st["total_notfinite"],
                                             st["total_notfinite"] + 1)
        return torch.where(accept, upd, torch.zeros_like(upd)), new

    @staticmethod
    def flatten(params: list[torch.Tensor], grads) -> torch.Tensor:
        """The flat f32 gradient, zeros where a parameter got none."""
        return torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1).float()
                          for p, g in zip(params, grads)])

    @torch.no_grad()
    def apply(self, params: list[torch.Tensor], updates: torch.Tensor) -> None:
        parts = torch.split(updates, [p.numel() for p in params])
        torch._foreach_add_(params, [u.view_as(p) for u, p in zip(parts, params)])


def make_optimizer(opt_cfg: OptimConfig, train_cfg: TrainConfig) -> Optimizer:
    return Optimizer(opt_cfg, train_cfg)
