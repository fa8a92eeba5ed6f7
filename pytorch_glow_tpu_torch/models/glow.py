"""The multi-scale Glow model as an `nn.Module`.

Counterpart of `pytorch_glow_tpu/models/glow.py`.  Module names follow the
reference lineage's `state_dict` (`flow.layers.{j}` counting the paramless
Squeeze layers, then `learn_top`), so `utils/convert.state_dict_from_jax`
loads JAX parameters directly.

Flow steps run one of two ways per `cfg.flowstep_impl`:

* "pallas": the fused flow step of `ops/flowstep.py` — the hand-written
  CUDA kernels on a CUDA tensor, their plain PyTorch version on a CPU
  tensor, through the autograd Functions `FusedStep` / `FusedStepReverse`
  (the backward kernel K3 recomputes the step from its saved input).  Each
  level keeps the NHWC (pixel-major) layout the kernels take and adds the
  z-free logdet terms, H*W * sum(param_logdet), outside them; those and the
  weight packing are plain autograd.
* "xla": the unfused layer math of `models/layers.py` at `compute_dtype`.
  With `cfg.remat`, while grad is enabled, each flow step runs under
  activation checkpointing (`torch.utils.checkpoint`, non-reentrant): the
  backward recomputes the step from its input, as the JAX package's
  `jax.checkpoint` of the scan body does.  Not under DDI, which the JAX
  package also runs without it.  On the fused path remat has nothing to
  add: `FusedStep` already saves only each step's input, and its backward
  kernel recomputes the step.

Each step's channel permutation is the profile's (`flow_permutation`,
`lu_decomposed`): the LU 1x1 conv, the plain 1x1 conv, or a fixed shuffle /
reverse.  The fused path takes each of them as its (C, C) mix matrix.  On
the unfused path, `invconv_impl="pallas"` sends the LU 1x1 conv through the
kernels K6a / K6b (`ops/invconv_fused.py`).

`ddi_init` always runs the unfused path, as the JAX package does, so DDI
under `invconv_impl="pallas"` launches K6a whatever `flowstep_impl` says.
It moves only the flow's actnorms: the top prior's, the class heads' and
the variational dequantizer's parameters stay as they are.

y-conditioning (`cfg.y_condition`): the top prior's mean and log-scale are
shifted by `project_ycond(y_onehot)` and `log_prob` returns the class
logits `y_logits = project_class(mean of z over H, W)`; `loss_fn` adds
`weight_y` times the class loss (softmax cross-entropy over one-hot
labels, or per-attribute BCE-with-logits under `y_multi_class`).  Both
heads are `LinearZeros` under the lineage's names.

`dequant="variational"`: with a generator, `log_prob` dequantizes through
the learned q(u|x) of `models/vardeq.py` (`self.vardeq`) and folds its
-log q into the objective.  `nll_bound` is the Monte-Carlo bound on the
discrete NLL (ELBO or IWAE) over k sequential draws.

Explicit noise: every random path also takes its draws as tensors, so that
an exported graph (`serve.py`) takes them as inputs: `sample(noise=[top,
split L-2, ..., split 0])` and `decode(noise=[split L-2, ..., split 0])`
take the standard normal draws in the order the live call draws them
(`noise_shapes`), `log_prob(noise=u)` and `nll_bound(noise=[u, ...])` the
raw dequantization draw of x's shape (U[0, 1) for uniform and variational,
a standard normal for gaussian).  Draws taken outside from a generator in
that order give the live call's result bit for bit.

On a mesh (`self.mesh`, set by `parallel/mesh.shard_model`): DDI takes the
global batch's statistics over the data group, and a model whose coupling
nets hold tensor-parallel shards (`holds_shards`, model > 1) runs them
over the model group (`models/layers.CouplingNet`: column / row parallel
on a whole level, gathered on a spatially sharded one).  The fused
kernels keep the whole hidden width, as the JAX kernels' partitioning
keeps the weights replicated: before a level's steps, their conv1 and
conv2 are gathered over the model group in one collective
(`models/layers.gather_from_model`), and the backward hands each shard
its slice of the kernel's gradient: on a
whole level (every model peer runs K1/K3 on the same rows) the slice
itself, on a sharded level (K4/K5 on each rank's slab) the slice of the
peers' sum.  An eval copy on the mesh holds whole weights
(`holds_shards` False) and gathers nothing.

Spatial sharding (`cfg.shard_spatial` on a mesh with model > 1, set up
by `set_mesh`; `parallel/spatial.py` says which levels and how gradients
flow): at the start of each sharded level, encode and decode hold the
rank's row slab of the level's activations, the counterpart of JAX's
`_maybe_shard_spatial`.  On the fused path every step exchanges HALO rows
with the neighbouring ranks (a one-row slab takes them from the level
all-gathered) and runs the band chain on the padded slab
(`ops/flowstep.FusedStep` with a `Slab`, K4/K5 in slab form); on the unfused path
the 3x3 convs exchange one row each (`models/layers`).  Every term that
counts pixels of a sharded level (actnorm, 1x1 conv and coupling logdets,
the split priors' log-probs, H*W*sum(param_logdet)) adds to a partial
logdet that is summed over the model group once, at the end of encode
(`sum_partial`).  The public results are whole on every rank: encode
gathers z and the split halves, decode the image; random draws are made
for the whole batch and each rank keeps its rows, so a sharded sample
equals the unsharded one for the same generator.

Under `torch.export` (`torch.compiler.is_exporting()`) the fused path calls
the flow-step kernels through their `torch.library` ops
(`ops/library.py`), which the exporter keeps opaque; the live path calls
the autograd Functions.

While a torch.profiler session runs (`utils/spans.py`), `sample` records a
`glow.sample` span, each level of encode and decode a `glow.level` span,
and each fused flow step a `chain.forward` or `chain.reverse` span around
its weight packing, halo exchange and kernel call.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_glow_tpu_torch.config import GlowConfig
from pytorch_glow_tpu_torch.models.layers import (
    ActNorm,
    Conv2dZeros,
    FlowStep,
    LinearZeros,
    Split2d,
    Squeeze,
    gather_from_model,
)
from pytorch_glow_tpu_torch.models.vardeq import VarDeq
from pytorch_glow_tpu_torch.ops import flowstep as fs
from pytorch_glow_tpu_torch.ops import library
from pytorch_glow_tpu_torch.ops.math import (
    bits_per_dim,
    discretization_correction,
    gaussian_logp,
    gaussian_sample,
    num_dims,
)
from pytorch_glow_tpu_torch.ops.reshape import split_channel, squeeze2d, unsqueeze2d
from pytorch_glow_tpu_torch.parallel import spatial
from pytorch_glow_tpu_torch.utils import spans

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _FlowNet(nn.Module):
    def __init__(self, layers: list[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Glow(nn.Module):
    def __init__(self, cfg: GlowConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.flowstep_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown flowstep_impl: {cfg.flowstep_impl}")
        self.cfg = cfg
        dtype = _DTYPES[cfg.compute_dtype]
        layers: list[nn.Module] = []
        self._levels: list[tuple[list[FlowStep], Split2d | None]] = []
        shapes = cfg.latent_shapes()
        for i, (_, _, c) in enumerate(shapes):
            layers.append(Squeeze())
            steps = [
                FlowStep(c, cfg.hidden_channels, cfg.flow_coupling, dtype,
                         cfg.actnorm_scale, generator, cfg.flow_permutation,
                         cfg.lu_decomposed, cfg.invconv_impl)
                for _ in range(cfg.K)
            ]
            layers.extend(steps)
            split = Split2d(c) if i < cfg.L - 1 else None
            if split is not None:
                layers.append(split)
            self._levels.append((steps, split))
        self.flow = _FlowNet(layers)
        c_final = shapes[-1][2]
        if cfg.learn_top:
            self.learn_top = Conv2dZeros(2 * c_final, 2 * c_final)
        if cfg.y_condition:
            self.project_ycond = LinearZeros(cfg.y_classes, 2 * c_final)
            self.project_class = LinearZeros(c_final, cfg.y_classes)
        if cfg.dequant == "variational":
            self.vardeq = VarDeq(cfg, generator)
        self._ddi = False
        self.mesh = None  # parallel.mesh.Mesh, set by set_mesh
        self.holds_shards = False  # conv1 / conv2 hold tensor-parallel shards (shard_model)
        self._sharded = [False] * cfg.L  # per level: on row slabs over the model group

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_mesh(self, mesh) -> "Glow":
        """Run on `mesh` (`parallel/mesh.shard_model` calls it): DDI's
        statistics over its data group; the coupling nets of a model that
        holds shards over its model group, each told whether its level
        runs on row slabs; and under spatial sharding the levels
        `spatial.level_sharded` picks on row slabs, their 3x3 convs
        exchanging halo rows."""
        self.mesh = mesh
        self._sharded = [spatial.level_sharded(self.cfg, mesh, h)
                         for h, _, _ in self.cfg.latent_shapes()]
        halo = None
        if any(self._sharded):
            def halo(x, k):
                return spatial.exchange(x, k, mesh)
        group = mesh.model_group if mesh is not None and self.holds_shards else None
        for (steps, split), sharded in zip(self._levels, self._sharded):
            for step in steps:
                step.f[0].halo = step.f[4].halo = halo if sharded else None
                step.f.model_group, step.f.rows_sharded = group, sharded
            if split is not None:
                split.conv.halo = halo if sharded else None
        return self

    def row_partial_parameters(self) -> list[nn.Parameter]:
        """The parameters whose gradient on this rank is its rows' partial:
        those of the spatially sharded levels' flow steps and split priors,
        but for the gathered shards, whose backward sums over the model
        group itself (`models/layers.gather_from_model`)."""
        out: list[nn.Parameter] = []
        for (steps, split), sharded in zip(self._levels, self._sharded):
            if not sharded:
                continue
            for step in steps:
                gathered = {id(p) for p, _ in step.f.shards()} if self.holds_shards else set()
                out.extend(p for p in step.parameters() if id(p) not in gathered)
            if split is not None:
                out.extend(split.parameters())
        return out

    def _slab(self, level: int) -> fs.Slab | None:
        """Where this rank's rows of a sharded level lie, else None."""
        if not self._sharded[level]:
            return None
        h = self.cfg.latent_shapes()[level][0]
        return fs.Slab(self.mesh.model_rank * (h // self.mesh.model), h)

    # -- flow steps ----------------------------------------------------------

    def _fused(self) -> bool:
        return self.cfg.flowstep_impl == "pallas" and not self._ddi

    def _full_weights(self, steps: list[FlowStep], slab: fs.Slab | None) -> list:
        """Per step, the full tensors of its tensor-parallel shards for the
        fused kernels (None without shards): one collective for the level,
        whose backward reduce-scatters on a sharded level (`slab`)."""
        if not self.holds_shards:
            return [None] * len(steps)
        shards = [pair for step in steps for pair in step.f.shards()]
        full = gather_from_model(shards, self.mesh.model_group, partial=slab is not None)
        return [full[4 * i:4 * i + 4] for i in range(len(steps))]

    def _steps_forward(self, steps: list[FlowStep], z: torch.Tensor, logdet: torch.Tensor,
                       slab: fs.Slab | None = None):
        """K steps forward; with a slab, z is the rank's row slab and the
        logdet added is its partial."""
        if not self._fused():
            remat = self.cfg.remat and not self._ddi and torch.is_grad_enabled()
            for step in steps:
                if remat:
                    z, logdet = checkpoint(step, z, logdet, use_reentrant=False)
                else:
                    z, logdet = step(z, logdet)
            return z, logdet
        affine = self.cfg.flow_coupling == "affine"
        z = z.float().contiguous()
        exporting = torch.compiler.is_exporting()
        for step, full in zip(steps, self._full_weights(steps, slab)):
            with spans.span("chain.forward"):
                packed = fs.pack_weights(step, affine, False, fs.COUPLING_DTYPE, full)
                if slab is not None:
                    z = spatial.exchange(z, fs.HALO, self.mesh)
                if exporting:
                    z, ld = library.flowstep_forward(z, affine, packed)
                else:
                    z, ld = fs.FusedStep.apply(z, affine, slab, *packed)
            logdet = logdet + ld
        plds = torch.stack([fs.param_logdet(step) for step in steps]).sum()
        return z, logdet + z.shape[1] * z.shape[2] * plds

    def _steps_reverse(self, steps: list[FlowStep], z: torch.Tensor,
                       slab: fs.Slab | None = None) -> torch.Tensor:
        if not self._fused():
            for step in reversed(steps):
                z = step.reverse(z)
            return z
        affine = self.cfg.flow_coupling == "affine"
        z = z.float().contiguous()
        exporting = torch.compiler.is_exporting()
        for step, full in reversed(list(zip(steps, self._full_weights(steps, slab)))):
            with spans.span("chain.reverse"):
                packed = fs.pack_weights(step, affine, True, fs.COUPLING_DTYPE, full)
                if slab is not None:
                    z = spatial.exchange(z, fs.HALO, self.mesh)
                if exporting:
                    z = library.flowstep_reverse(z, affine, packed)
                else:
                    z = fs.FusedStepReverse.apply(z, affine, slab, *packed)
        return z

    # -- encode / decode -----------------------------------------------------

    def _encode(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        """encode with the split halves of sharded levels left as the
        rank's slabs; z and the logdet are whole."""
        if logdet is None:
            logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        z = x
        z_splits: list[torch.Tensor] = []
        partial = None  # the sharded levels' logdet terms, this rank's rows
        sharded = False
        for level, (steps, split) in enumerate(self._levels):
            with spans.span("glow.level", level=level, direction="encode"):
                now = self._sharded[level]
                if sharded and not now:
                    z = spatial.gather_rows(z, self.mesh)
                z = squeeze2d(z, 2)
                if now and not sharded:
                    z = spatial.shard_rows(z, self.mesh)
                sharded = now
                if now:
                    if partial is None:
                        partial = torch.zeros_like(logdet)
                    z, partial = self._steps_forward(steps, z, partial, self._slab(level))
                    if split is not None:
                        z, partial, z2 = split(z, partial)
                        z_splits.append(z2)
                    continue
                z, logdet = self._steps_forward(steps, z, logdet)
                if split is not None:
                    z, logdet, z2 = split(z, logdet)
                    z_splits.append(z2)
        if sharded:
            z = spatial.gather_rows(z, self.mesh)
        if partial is not None:
            logdet = logdet + spatial.sum_partial(partial, self.mesh)
        return z, logdet, z_splits

    def encode(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        """x (B, H, W, C) -> (z_final, logdet, z_splits), whole on every rank
        under spatial sharding."""
        z, logdet, z_splits = self._encode(x, logdet)
        z_splits = [spatial.gather_rows(z2, self.mesh) if sharded else z2
                    for z2, sharded in zip(z_splits, self._sharded)]
        return z, logdet, z_splits

    def decode(self, z: torch.Tensor, generator: torch.Generator | None = None,
               temperature: float = 1.0, z_splits: list[torch.Tensor] | None = None,
               noise: list[torch.Tensor] | None = None) -> torch.Tensor:
        """z -> x.  With `z_splits` the reconstruction is exact; otherwise each
        Split2d draws its half from the learned prior at `temperature`, its
        standard normal draw from `generator` or from `noise` (one per
        split, the deepest first: `noise_shapes(b)[1:]`).  On sharded levels
        each rank keeps its rows of z, of the halves given (whole, or its
        slabs from `_encode`) and of the whole batch's draws."""
        draws = iter(noise) if noise is not None else None
        shapes = self.cfg.latent_shapes()
        sharded = False
        for i in range(len(self._levels) - 1, -1, -1):
            with spans.span("glow.level", level=i, direction="decode"):
                steps, split = self._levels[i]
                now = self._sharded[i]
                if now and not sharded:
                    z = spatial.shard_rows(z, self.mesh)
                sharded = now
                if split is not None:
                    if z_splits is not None:
                        z2 = z_splits[i]
                        if now and z2.shape[1] == shapes[i][0]:
                            z2 = spatial.shard_rows(z2, self.mesh)
                        z = split.reverse(z, z2=z2)
                    else:
                        eps = next(draws) if draws is not None else None
                        if now:
                            if eps is None:
                                b, (h, w, c) = z.shape[0], shapes[i]
                                eps = torch.randn((b, h, w, c // 2), generator=generator,
                                                  dtype=torch.float32, device=z.device)
                            eps = spatial.own_rows(eps, self.mesh)
                        z = split.reverse(z, generator, temperature, eps=eps)
                z = self._steps_reverse(steps, z, self._slab(i))
                z = unsqueeze2d(z, 2)
        if sharded:
            z = spatial.gather_rows(z, self.mesh)
        return z

    def noise_shapes(self, batch: int) -> list[tuple[int, ...]]:
        """The shapes of `sample`'s standard normal draws, in the order it
        takes them: the top latent, then each split's half, the deepest
        first (`decode` takes all but the first)."""
        shapes = [(batch, *self.cfg.final_latent_shape)]
        for h, w, c in reversed(self.cfg.latent_shapes()[:-1]):
            shapes.append((batch, h, w, c // 2))
        return shapes

    def top_prior(self, batch: int, y_onehot: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, logs) of the final-latent prior, shape (B, 1, 1, C_final).

        The learned prior convolves a zeros input, so its output is the
        scaled bias b * exp(3 * logs) at every pixel; a y-conditional model
        adds `project_ycond(y_onehot)` (B, 2 * C_final) to it."""
        c = self.cfg.final_latent_shape[-1]
        h = torch.zeros(batch, 1, 1, 2 * c, dtype=torch.float32, device=self.device)
        if self.cfg.learn_top:
            top = self.learn_top
            h = h + top.bias * torch.exp(top.logs.view(-1) * 3.0)
        if self.cfg.y_condition:
            if y_onehot is None:
                raise ValueError("a y_condition model needs y_onehot")
            h = h + self.project_ycond(y_onehot)[:, None, None, :]
        return split_channel(h, "simple")

    # -- public API ------------------------------------------------------------

    def preprocess(self, x_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 [0,255] -> n_bits-reduced float in [0,1)."""
        x = x_uint8.float()
        if self.cfg.n_bits_x < 8:
            return torch.floor(x / 2 ** (8 - self.cfg.n_bits_x)) / self.cfg.n_bins
        return x / 256.0

    def postprocess(self, x: torch.Tensor) -> torch.Tensor:
        """float [0,1) -> uint8 image."""
        n_bins = self.cfg.n_bins
        return torch.clamp(torch.floor(x * n_bins) * (256.0 / n_bins), 0, 255).to(torch.uint8)

    def dequantize(self, x: torch.Tensor, generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
        """Dequantization noise on [0,1)-scaled inputs (uniform by default),
        drawn from `generator` or given as `noise` (x's shape).
        Parameter-free: under `dequant="variational"` it adds uniform noise
        (DDI batches); the learned q(u|x) runs in `log_prob`."""
        dq = self.cfg.dequant
        if dq in ("uniform", "variational"):
            if noise is None:
                noise = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            return x + noise / self.cfg.n_bins
        if dq == "gaussian":
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            return x + noise / self.cfg.n_bins
        return x

    def dequant_noise(self, shape, generator: torch.Generator | None,
                      device) -> torch.Tensor | None:
        """The raw dequantization draw `log_prob` takes of a batch of
        `shape`, from `generator`, as it would draw it itself: U[0, 1) for
        uniform and variational, a standard normal for gaussian, None
        without dequantization."""
        dq = self.cfg.dequant
        if dq in ("uniform", "variational"):
            return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        if dq == "gaussian":
            return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return None

    def log_prob(self, x: torch.Tensor, generator: torch.Generator | None = None,
                 y_onehot: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        """x in [0,1) -> {z, objective, nll (bits/dim)}, with "y_logits"
        on a y-conditional model; with a generator (or the draw itself,
        `noise`, x's shape) the input is dequantized first, and under
        variational dequantization "neg_log_q", -log q(u|x), is returned and
        folded into the objective."""
        cfg = self.cfg
        dims = num_dims((x.shape[0], *cfg.image_shape))
        neg_log_q = None
        if generator is not None or noise is not None:
            if cfg.dequant == "variational":
                x, neg_log_q = self.vardeq(x, generator, noise)
            else:
                x = self.dequantize(x, generator, noise)
        logdet = torch.full((x.shape[0],), discretization_correction(dims, cfg.n_bins),
                            dtype=torch.float32, device=x.device)
        if neg_log_q is not None:
            logdet = logdet + neg_log_q
        z, objective, _ = self._encode(x, logdet)
        mean, logs = self.top_prior(x.shape[0], y_onehot)
        objective = objective + gaussian_logp(mean, logs, z.float())
        out = {"z": z, "objective": objective, "nll": bits_per_dim(objective, dims)}
        if neg_log_q is not None:
            out["neg_log_q"] = neg_log_q
        if cfg.y_condition:
            out["y_logits"] = self.project_class(z.float().mean(dim=(1, 2)))
        return out

    def nll_bound(self, x: torch.Tensor, generator: torch.Generator | None, samples: int = 1,
                  bound: str = "elbo", y_onehot: torch.Tensor | None = None,
                  noise: list[torch.Tensor] | None = None) -> torch.Tensor:
        """Monte-Carlo bound on the discrete NLL in bits/dim, shape (B,).

        `log_prob` without a generator evaluates the density at the bin
        corner, which is not a bound on the discrete likelihood P(x).  This
        is: each of `samples` draws, taken in turn from `generator` (one
        pass's activations at a time), gives the objective of x dequantized
        by that draw, whose -log q term is already folded in under both
        uniform and variational q.  "elbo" is the mean of the per-draw
        objectives (k=1 is the published protocol), "iwae" the importance
        bound logsumexp - log k (Burda et al. 2016, arXiv:1509.00519).
        `noise` gives the `samples` draws instead of `generator`, one
        `log_prob` noise each."""
        if bound not in ("elbo", "iwae"):
            raise ValueError(f"unknown bound: {bound!r} (elbo | iwae)")
        if self.cfg.dequant not in ("uniform", "variational"):
            # gaussian / none noise has no (or an unbounded-support) q-density
            # folded into the objective.
            raise ValueError(
                f"nll_bound is only a valid discrete-NLL bound for "
                f"dequant='uniform'/'variational', not {self.cfg.dequant!r}")
        if noise is not None and len(noise) != samples:
            raise ValueError(f"nll_bound: {len(noise)} noise draws for {samples} samples")
        objs = torch.stack([
            self.log_prob(x, generator, y_onehot, None if noise is None else noise[i])["objective"]
            for i in range(samples)])
        if bound == "iwae":
            obj = torch.logsumexp(objs, dim=0) - math.log(samples)
        else:
            obj = objs.mean(dim=0)
        return bits_per_dim(obj, num_dims((x.shape[0], *self.cfg.image_shape)))

    def loss_fn(self, x: torch.Tensor, generator: torch.Generator | None = None,
                y_onehot: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """Training loss on [0,1) images -> (loss, metrics): the mean nll in
        bits/dim, plus `weight_y` times the class loss on a y-conditional
        model; with a generator (or its draw, `noise`, as `log_prob` takes
        it) the input is dequantized first.  Metrics:
        "nll", "loss", and "loss_class" and "vardeq_logq_bits" (the bits/dim
        the learned q charges for its noise) where they apply."""
        cfg = self.cfg
        extra = {} if noise is None else {"noise": noise}
        out = self.log_prob(x, generator, y_onehot, **extra)
        loss = out["nll"].mean()
        metrics = {"nll": loss}
        if "neg_log_q" in out:
            dims = num_dims((x.shape[0], *cfg.image_shape))
            metrics["vardeq_logq_bits"] = -out["neg_log_q"].mean() / (math.log(2.0) * dims)
        if cfg.y_condition:
            logits = out["y_logits"]
            if cfg.y_multi_class:
                # BCE-with-logits per binary attribute, in its stable form.
                labels = (y_onehot > 0).float()
                cls = (torch.clamp_min(logits, 0) - logits * labels
                       + torch.log1p(torch.exp(-logits.abs()))).mean()
            else:
                cls = -(F.log_softmax(logits, dim=-1) * y_onehot).sum(dim=-1).mean()
            metrics["loss_class"] = cls
            loss = loss + cfg.weight_y * cls
        metrics["loss"] = loss
        return loss, metrics

    def sample(self, n: int, temperature: float = 1.0,
               generator: torch.Generator | None = None,
               y_onehot: torch.Tensor | None = None,
               noise: list[torch.Tensor] | None = None) -> torch.Tensor:
        """Temperature sampling -> float images in [0,1); a y-conditional
        model draws from the prior of `y_onehot` (n, y_classes).  The
        standard normal draws come from `generator`, or from `noise`
        (`noise_shapes(n)`, in that order)."""
        with spans.span("glow.sample", n=n):
            mean, logs = self.top_prior(n, y_onehot)
            top, splits = (None, None) if noise is None else (noise[0], noise[1:])
            z = gaussian_sample(mean, logs, temperature, generator, self.noise_shapes(n)[0], top)
            return self.decode(z, generator, temperature, noise=splits)

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) with the stored split halves: the exact round-trip."""
        z, _, z_splits = self.encode(x)
        return self.decode(z, z_splits=z_splits)

    @contextmanager
    def _ddi_mode(self):
        groups = {}  # id(actnorm) -> the groups its statistics reduce over
        if self.mesh is not None:
            data = (self.mesh.data_group,)
            for (steps, _), sharded in zip(self._levels, self._sharded):
                for step in steps:
                    for m in step.modules():
                        if isinstance(m, ActNorm):
                            groups[id(m)] = data + ((self.mesh.model_group,) if sharded else ())
        actnorms = [m for m in self.flow.modules() if isinstance(m, ActNorm)]
        self._ddi = True
        for m in actnorms:
            m.ddi, m.groups = True, groups.get(id(m), ())
        try:
            yield
        finally:
            self._ddi = False
            for m in actnorms:
                m.ddi, m.groups = False, ()

    @torch.no_grad()
    def ddi_init(self, x: torch.Tensor) -> "Glow":
        """Data-dependent actnorm init from one preprocessed+dequantized batch:
        one unfused encode in which every actnorm of the flow, in depth
        order, sets its parameters from the batch statistics of its input
        (on a mesh: this rank's rows, the global batch's statistics)."""
        with self._ddi_mode():
            self._encode(x)
        return self


def init_glow(cfg: GlowConfig, generator: torch.Generator | None = None,
              device: torch.device | str = "cuda") -> Glow:
    """Build the model with weights drawn from `generator` (a CPU generator),
    then move it to `device`: the card unless the caller passes "cpu".
    Without a card, "cuda" raises; nothing falls back to the CPU."""
    return Glow(cfg, generator).to(device)


# The JAX package's library API (README), model first instead of params.
def ddi_init(model: Glow, x: torch.Tensor) -> Glow:
    return model.ddi_init(x)


def log_prob(model: Glow, x: torch.Tensor, generator: torch.Generator | None = None,
             y_onehot: torch.Tensor | None = None) -> dict:
    return model.log_prob(x, generator, y_onehot)


def nll_bound(model: Glow, x: torch.Tensor, generator: torch.Generator, samples: int = 1,
              bound: str = "elbo", y_onehot: torch.Tensor | None = None) -> torch.Tensor:
    return model.nll_bound(x, generator, samples, bound, y_onehot)


def loss_fn(model: Glow, x: torch.Tensor, generator: torch.Generator | None = None,
            y_onehot: torch.Tensor | None = None):
    return model.loss_fn(x, generator, y_onehot)


def sample(model: Glow, n: int, temperature: float = 1.0,
           generator: torch.Generator | None = None,
           y_onehot: torch.Tensor | None = None) -> torch.Tensor:
    return model.sample(n, temperature, generator, y_onehot)
