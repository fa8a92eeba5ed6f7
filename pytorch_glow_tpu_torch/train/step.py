"""Train and eval steps over a state dict.

Counterpart of `pytorch_glow_tpu/train/step.py` (`init_state`,
`ema_params`, `make_train_step`, `make_train_step_n`, `make_eval_step_n`,
`make_sample_fn`, `make_reconstruct_fn`; the one eval step is
`make_eval_step_n`, N = 1 for a single batch).  The state is {"step": int,
"model": Glow, "opt_state": dict, "seed": int, and "ema": list of tensors
when ema_decay > 0}; the model holds the parameters and is updated in
place.  The eval, sample and reconstruct functions take the model to run
(the JAX ones take a params tree); the trainer hands them its eval copy
holding the EMA or the live weights.  A y-conditional model's train, eval
and sample functions take the labels as the JAX ones do: `y_onehot`
(B, y_classes), stacked (N, B, y_classes) for N steps or batches, on any
device (they move to the model's); None on an unconditional model.

Per-step randomness comes from a `torch.Generator` seeded from (seed, step)
alone, so a resumed run draws the same noise; the flips use a separate
stream, as the JAX package's `fold_in(rng, 0xF11B)` does.  The numbers
differ from `jax.random`'s: tests hand both sides the same numpy noise.

On a mesh (`parallel/mesh.py`) each rank's batch is its rows of the global
batch.  The dequantization noise and the flips are drawn for the whole
global batch and each rank keeps its rows, as JAX draws them once for the
sharded global array, so N ranks compute what one rank does on the global
batch.  The flat gradient is mean-all-reduced over the data group before
the optimizer (the counterpart of GSPMD's gradient psum and of the fused
backward's in-kernel psum), and the metrics are data-group means, equal
on every rank; the eval nll likewise.  Under spatial sharding
(`parallel/spatial.py`) model peers hold the same images and each computes
the gradient of its slab of a sharded level's rows for that level's
replicated parameters: those entries (`spatial.partial_mask`) are summed
over the model group first, so that every rank holds the whole gradient
(of its tensor-parallel shards, their slice, which their gathers' backward
already summed) before the data mean and the global-norm clip.

While a torch.profiler session runs, each train step records the spans
`train.step` (the root: input prep, flips, generators, metrics) over
`train.forward`, `train.backward`, `train.optimizer` and `train.ema`
(`utils/spans.py`).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from pytorch_glow_tpu_torch.config import GlowConfig
from pytorch_glow_tpu_torch.models.glow import Glow
from pytorch_glow_tpu_torch.ops.math import true_f32
from pytorch_glow_tpu_torch.parallel import distributed as pd
from pytorch_glow_tpu_torch.parallel import spatial
from pytorch_glow_tpu_torch.parallel.mesh import Mesh
from pytorch_glow_tpu_torch.train.optim import Optimizer
from pytorch_glow_tpu_torch.utils import spans

State = dict[str, Any]
FLIP_STREAM = 0xF11B


def trainable(model: Glow) -> list[tuple[str, torch.Tensor]]:
    """The trainable parameters, in `named_parameters` order.  The LU
    permutation and signs are buffers, so nothing frozen is among them."""
    return [(name, p) for name, p in model.named_parameters() if p.requires_grad]


def init_state(model: Glow, tx: Optimizer, ema_decay: float = 0.0, seed: int = 0) -> State:
    """Fresh training state (the model still needs `ddi_init` on a batch)."""
    params = [p for _, p in trainable(model)]
    state = {"step": 0, "model": model, "opt_state": tx.init(params), "seed": seed}
    if ema_decay > 0:
        state["ema"] = [p.detach().clone() for p in params]
    return state


def ema_params(state: State) -> dict[str, torch.Tensor]:
    """The model's `state_dict` with the EMA trainables (the live ones
    without an EMA), for `load_state_dict` into an eval copy."""
    sd = state["model"].state_dict()
    if "ema" in state:
        sd.update({name: e for (name, _), e in zip(trainable(state["model"]), state["ema"])})
    return sd


def step_generator(seed: int, step: int, device, stream: int | None = None) -> torch.Generator:
    """The generator of one step (or one of its side streams)."""
    key = (seed, step) if stream is None else (seed, step, stream)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> 1))
    return gen


def ema_decay_at(decay: float, step: int) -> float:
    """min(decay, (1 + s) / (10 + s)) in f32, as the JAX step computes it."""
    s = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(10.0) + s)))


def _check_model(model: Glow, cfg: GlowConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("the state's model was built from another GlowConfig than this step's")


def _prep(model: Glow, batch: torch.Tensor) -> torch.Tensor:
    batch = batch.to(model.device)
    return model.preprocess(batch) if batch.dtype == torch.uint8 else batch.float()


def _labels(model: Glow, y_onehot: torch.Tensor | None) -> torch.Tensor | None:
    return None if y_onehot is None else y_onehot.to(model.device)


def global_rows(mesh: Mesh | None, local: int) -> tuple[int, int, int]:
    """(global batch, first row, end row) of this rank's `local` rows."""
    if mesh is None:
        return local, 0, local
    return local * mesh.data, mesh.data_rank * local, (mesh.data_rank + 1) * local


def data_mean(values: dict[str, torch.Tensor], mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """Each scalar's mean over the data group (one all-reduce)."""
    if mesh is None or not values:
        return values
    stacked = pd.mean_(torch.stack([v.float() for v in values.values()]), mesh.data_group)
    return dict(zip(values, stacked.unbind()))


def row_partial_index(model: Glow, named) -> torch.Tensor | None:
    """The flat gradient's row-partial entries (`spatial.partial_mask`) as an
    index tensor, None without any (one device sync, at the first step)."""
    mask = spatial.partial_mask(model, named)
    return None if mask is None else mask.nonzero().squeeze(1)


def sum_row_partials(flat: torch.Tensor, index: torch.Tensor | None, mesh: Mesh | None) -> None:
    """The flat gradient's row-partial entries (`index`) summed in place over
    the model group."""
    if mesh is None or index is None:
        return
    part = pd.all_reduce_(flat.index_select(0, index), mesh.model_group)
    flat.index_copy_(0, index, part)


def _make_train_step_fn(cfg: GlowConfig, tx: Optimizer, ema_decay: float = 0.0,
                        schedule=None, augment_flip: bool = False, mesh: Mesh | None = None):
    partials: dict[int, torch.Tensor | None] = {}  # id(model) -> its row-partial index

    def train_step(state: State, batch: torch.Tensor, y_onehot: torch.Tensor | None = None):
        with spans.span("train.step", step=state["step"]):
            return one_step(state, batch, y_onehot)

    def one_step(state: State, batch: torch.Tensor, y_onehot: torch.Tensor | None):
        model: Glow = state["model"]
        _check_model(model, cfg)
        step = state["step"]
        dev = model.device
        x = _prep(model, batch)
        n, lo, hi = global_rows(mesh, x.shape[0])
        gen = step_generator(state["seed"], step, dev)
        if augment_flip:
            flip_gen = step_generator(state["seed"], step, dev, FLIP_STREAM)
            flip = (torch.rand(n, generator=flip_gen, device=dev) < 0.5)[lo:hi]
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        names_params = trainable(model)
        params = [p for _, p in names_params]
        with spans.span("train.forward"):
            if mesh is None:
                loss, metrics = model.loss_fn(x, gen, _labels(model, y_onehot))
            else:
                noise = model.dequant_noise((n, *x.shape[1:]), gen, dev)
                loss, metrics = model.loss_fn(x, y_onehot=_labels(model, y_onehot),
                                              noise=None if noise is None else noise[lo:hi])
        # The backward's f32 convs run after their forward's pin has ended.
        with spans.span("train.backward"), true_f32():
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with spans.span("train.optimizer"):
            flat = tx.flatten(params, grads)
            if mesh is not None:
                if id(model) not in partials:
                    partials[id(model)] = row_partial_index(model, names_params)
                sum_row_partials(flat, partials[id(model)], mesh)
                pd.mean_(flat, mesh.data_group)
            updates, opt_state = tx.update(flat, state["opt_state"])
            tx.apply(params, updates)
            metrics = data_mean({k: v.detach() for k, v in metrics.items()}, mesh)
            metrics["grad_norm"] = tx.global_norm(flat)
            if schedule is not None:
                metrics["lr"] = schedule(torch.tensor(step, dtype=torch.int32, device=dev))
        new_state = {**state, "step": step + 1, "opt_state": opt_state}
        if ema_decay > 0:
            d = ema_decay_at(ema_decay, step)
            with spans.span("train.ema"), torch.no_grad():
                ema = state["ema"]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - d)))
        return new_state, metrics

    return train_step


def make_train_step(cfg: GlowConfig, tx: Optimizer, ema_decay: float = 0.0, schedule=None,
                    augment_flip: bool = False, mesh: Mesh | None = None) -> Callable:
    """-> (state, image batch[, y_onehot]) -> (state, metrics); metrics stay
    on the device.  On a `mesh` the batch is this rank's rows."""
    return _make_train_step_fn(cfg, tx, ema_decay, schedule, augment_flip, mesh)


def make_train_step_n(cfg: GlowConfig, tx: Optimizer, n: int, ema_decay: float = 0.0,
                      schedule=None, augment_flip: bool = False,
                      mesh: Mesh | None = None) -> Callable:
    """n train steps per call over stacked (n, B, H, W, C) batches (and
    (n, B, y_classes) labels), with the trajectory of n single calls;
    returns the last step's metrics."""
    one = _make_train_step_fn(cfg, tx, ema_decay, schedule, augment_flip, mesh)

    def train_step_n(state: State, batches: torch.Tensor, y_onehot: torch.Tensor | None = None):
        if batches.shape[0] != n:
            raise ValueError(f"expected {n} stacked batches, got {batches.shape[0]}")
        metrics = {}
        for i in range(n):
            state, metrics = one(state, batches[i], None if y_onehot is None else y_onehot[i])
        return state, metrics

    return train_step_n


def make_eval_step_n(cfg: GlowConfig, mesh: Mesh | None = None) -> Callable:
    """(model, (N, B, H, W, C) batches[, (N, B, y_classes) labels]) ->
    {"nll": the mean over the N batches of each batch's mean bits/dim},
    without dequantization noise, summed in f32 in batch order as the JAX
    fori_loop sums; on a `mesh` the batches are this rank's rows and the
    nll their data-group mean."""

    @torch.no_grad()
    def eval_step_n(model: Glow, batches: torch.Tensor, y_onehot: torch.Tensor | None = None):
        _check_model(model, cfg)
        total = torch.zeros((), dtype=torch.float32, device=model.device)
        for i, batch in enumerate(batches):
            y = None if y_onehot is None else _labels(model, y_onehot[i])
            total = total + model.log_prob(_prep(model, batch), y_onehot=y)["nll"].mean()
        return data_mean({"nll": total / batches.shape[0]}, mesh)

    return eval_step_n


def make_sample_fn(cfg: GlowConfig, n: int, temperature: float) -> Callable:
    """(model, generator, temperature=None, y_onehot=None) -> n uint8
    samples; `temperature` overrides the default given here (the trainer's
    annealed plot temperature)."""

    default = temperature

    @torch.no_grad()
    def sample_fn(model: Glow, generator: torch.Generator, temperature: float | None = None,
                  y_onehot: torch.Tensor | None = None):
        _check_model(model, cfg)
        t = default if temperature is None else temperature
        return model.postprocess(model.sample(n, float(t), generator, _labels(model, y_onehot)))

    return sample_fn


def make_reconstruct_fn(cfg: GlowConfig) -> Callable:
    """(model, uint8 or [0,1) batch) -> uint8 decode(encode(batch))."""

    @torch.no_grad()
    def reconstruct_fn(model: Glow, batch: torch.Tensor):
        _check_model(model, cfg)
        return model.postprocess(model.reconstruct(_prep(model, batch)))

    return reconstruct_fn
