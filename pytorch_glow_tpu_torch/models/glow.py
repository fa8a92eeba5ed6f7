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

Not ported yet: y-conditioning, `nll_bound`, variational dequantization.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_glow_tpu_torch.config import GlowConfig
from pytorch_glow_tpu_torch.models.layers import ActNorm, Conv2dZeros, FlowStep, Split2d, Squeeze
from pytorch_glow_tpu_torch.ops import flowstep as fs
from pytorch_glow_tpu_torch.ops.math import (
    bits_per_dim,
    discretization_correction,
    gaussian_logp,
    gaussian_sample,
    num_dims,
)
from pytorch_glow_tpu_torch.ops.reshape import split_channel, squeeze2d, unsqueeze2d

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _FlowNet(nn.Module):
    def __init__(self, layers: list[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Glow(nn.Module):
    def __init__(self, cfg: GlowConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.y_condition:
            raise NotImplementedError("y_condition is not ported yet")
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
        self._ddi = False

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- flow steps ----------------------------------------------------------

    def _fused(self) -> bool:
        return self.cfg.flowstep_impl == "pallas" and not self._ddi

    def _steps_forward(self, steps: list[FlowStep], z: torch.Tensor, logdet: torch.Tensor):
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
        for step in steps:
            packed = fs.pack_weights(step, affine, False, fs.COUPLING_DTYPE)
            z, ld = fs.FusedStep.apply(z, affine, *packed)
            logdet = logdet + ld
        plds = torch.stack([fs.param_logdet(step) for step in steps]).sum()
        return z, logdet + z.shape[1] * z.shape[2] * plds

    def _steps_reverse(self, steps: list[FlowStep], z: torch.Tensor) -> torch.Tensor:
        if not self._fused():
            for step in reversed(steps):
                z = step.reverse(z)
            return z
        affine = self.cfg.flow_coupling == "affine"
        z = z.float().contiguous()
        for step in reversed(steps):
            packed = fs.pack_weights(step, affine, True, fs.COUPLING_DTYPE)
            z = fs.FusedStepReverse.apply(z, affine, *packed)
        return z

    # -- encode / decode -----------------------------------------------------

    def encode(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        """x (B, H, W, C) -> (z_final, logdet, z_splits)."""
        if logdet is None:
            logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        z = x
        z_splits: list[torch.Tensor] = []
        for steps, split in self._levels:
            z = squeeze2d(z, 2)
            z, logdet = self._steps_forward(steps, z, logdet)
            if split is not None:
                z, logdet, z2 = split(z, logdet)
                z_splits.append(z2)
        return z, logdet, z_splits

    def decode(self, z: torch.Tensor, generator: torch.Generator | None = None,
               temperature: float = 1.0, z_splits: list[torch.Tensor] | None = None) -> torch.Tensor:
        """z -> x.  With `z_splits` the reconstruction is exact; otherwise each
        Split2d draws its half from the learned prior at `temperature`."""
        for i in range(len(self._levels) - 1, -1, -1):
            steps, split = self._levels[i]
            if split is not None:
                if z_splits is not None:
                    z = split.reverse(z, z2=z_splits[i])
                else:
                    z = split.reverse(z, generator, temperature)
            z = self._steps_reverse(steps, z)
            z = unsqueeze2d(z, 2)
        return z

    def top_prior(self, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, logs) of the final-latent prior, shape (B, 1, 1, C_final).

        The learned prior convolves a zeros input, so its output is the
        scaled bias b * exp(3 * logs) at every pixel."""
        c = self.cfg.final_latent_shape[-1]
        h = torch.zeros(batch, 1, 1, 2 * c, dtype=torch.float32, device=self.device)
        if self.cfg.learn_top:
            top = self.learn_top
            h = h + top.bias * torch.exp(top.logs.view(-1) * 3.0)
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

    def dequantize(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Dequantization noise on [0,1)-scaled inputs (uniform by default)."""
        dq = self.cfg.dequant
        if dq in ("uniform", "variational"):
            noise = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            return x + noise / self.cfg.n_bins
        if dq == "gaussian":
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            return x + noise / self.cfg.n_bins
        return x

    def log_prob(self, x: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        """x in [0,1) -> {z, objective, nll (bits/dim)}; with a generator the
        input is dequantized first."""
        cfg = self.cfg
        dims = num_dims((x.shape[0], *cfg.image_shape))
        if generator is not None:
            if cfg.dequant == "variational":
                raise NotImplementedError("variational dequantization is not ported yet")
            x = self.dequantize(x, generator)
        logdet = torch.full((x.shape[0],), discretization_correction(dims, cfg.n_bins),
                            dtype=torch.float32, device=x.device)
        z, objective, _ = self.encode(x, logdet)
        mean, logs = self.top_prior(x.shape[0])
        objective = objective + gaussian_logp(mean, logs, z.float())
        return {"z": z, "objective": objective, "nll": bits_per_dim(objective, dims)}

    def loss_fn(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """Training loss on [0,1) images: mean nll in bits/dim ->
        (loss, {"nll", "loss"}); with a generator the input is dequantized
        first.  The class losses of y-conditioning are not ported."""
        loss = self.log_prob(x, generator)["nll"].mean()
        return loss, {"nll": loss, "loss": loss}

    def sample(self, n: int, temperature: float = 1.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Temperature sampling -> float images in [0,1)."""
        mean, logs = self.top_prior(n)
        hf, wf, cf = self.cfg.final_latent_shape
        z = gaussian_sample(mean, logs, temperature, generator, shape=(n, hf, wf, cf))
        return self.decode(z, generator, temperature)

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) with the stored split halves: the exact round-trip."""
        z, _, z_splits = self.encode(x)
        return self.decode(z, z_splits=z_splits)

    @contextmanager
    def _ddi_mode(self):
        actnorms = [m for m in self.modules() if isinstance(m, ActNorm)]
        self._ddi = True
        for m in actnorms:
            m.ddi = True
        try:
            yield
        finally:
            self._ddi = False
            for m in actnorms:
                m.ddi = False

    @torch.no_grad()
    def ddi_init(self, x: torch.Tensor) -> "Glow":
        """Data-dependent actnorm init from one preprocessed+dequantized batch:
        one unfused encode in which every actnorm, in depth order, sets its
        parameters from the batch statistics of its input."""
        with self._ddi_mode():
            self.encode(x)
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


def log_prob(model: Glow, x: torch.Tensor, generator: torch.Generator | None = None) -> dict:
    return model.log_prob(x, generator)


def loss_fn(model: Glow, x: torch.Tensor, generator: torch.Generator | None = None):
    return model.loss_fn(x, generator)


def sample(model: Glow, n: int, temperature: float = 1.0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    return model.sample(n, temperature, generator)
