"""Inferer: the serving entry point (NLL, sampling, encode/decode, reconstruct).

Counterpart of `pytorch_glow_tpu/inference.py`.  Two latent views:

* `encode` / `decode`: the final-level latent z_L only; decode draws the
  split halves from their priors at `temperature` (0.0 = prior means).
* `encode_full` / `decode_full`: z_L plus every Split2d half, the exact
  round-trip behind `reconstruct`.

Images are uint8 (or [0,1) float) NHWC tensors; they move to the model's
device, as do the labels `y_onehot` (B, y_classes) a y-conditional model
takes.  Results stay on that device.  `nll` is the noise-free density at
the bin corner; `nll_bound` the Monte-Carlo bound on the discrete NLL that
flow papers report.
"""

from __future__ import annotations

import torch

from pytorch_glow_tpu_torch.config import GlowConfig
from pytorch_glow_tpu_torch.models.glow import Glow


class Inferer:
    def __init__(self, model: Glow, cfg: GlowConfig | None = None):
        self.model = model.eval()
        self.cfg = cfg or model.cfg

    def _prep(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.model.device)
        return self.model.preprocess(x) if x.dtype == torch.uint8 else x.float()

    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        z, _, _ = self.model.encode(self._prep(images))
        return z

    @torch.no_grad()
    def encode_full(self, images) -> tuple[torch.Tensor, list[torch.Tensor]]:
        z, _, z_splits = self.model.encode(self._prep(images))
        return z, z_splits

    @torch.no_grad()
    def decode(self, z: torch.Tensor, generator: torch.Generator | None = None,
               temperature: float = 0.0) -> torch.Tensor:
        """z_L -> uint8 images."""
        return self.model.postprocess(self.model.decode(z, generator, temperature))

    @torch.no_grad()
    def decode_full(self, z: torch.Tensor, z_splits: list[torch.Tensor]) -> torch.Tensor:
        return self.model.postprocess(self.model.decode(z, z_splits=z_splits))

    def reconstruct(self, images) -> torch.Tensor:
        z, z_splits = self.encode_full(images)
        return self.decode_full(z, z_splits)

    def _labels(self, y_onehot) -> torch.Tensor | None:
        return None if y_onehot is None else torch.as_tensor(y_onehot).to(self.model.device)

    @torch.no_grad()
    def sample(self, n: int, temperature: float = 0.7,
               generator: torch.Generator | None = None, y_onehot=None) -> torch.Tensor:
        return self.model.postprocess(
            self.model.sample(n, temperature, generator, self._labels(y_onehot)))

    @torch.no_grad()
    def nll(self, images, y_onehot=None) -> torch.Tensor:
        """Noise-free NLL in bits/dim at the bin corner (the reference
        lineage's eval convention; fine for relative comparisons, not a
        bound on the discrete NLL), one value per image."""
        return self.model.log_prob(self._prep(images), y_onehot=self._labels(y_onehot))["nll"]

    @torch.no_grad()
    def nll_bound(self, images, samples: int = 1, bound: str = "elbo",
                  generator: torch.Generator | None = None, y_onehot=None) -> torch.Tensor:
        """The Monte-Carlo bound on the discrete NLL in bits/dim per image
        (`Glow.nll_bound`): samples=1 with "elbo" is the published protocol,
        more samples with "iwae" tighten it toward log P(x).  Without a
        generator the draws come from one seeded 0 on the model's device."""
        if generator is None:
            generator = torch.Generator(device=self.model.device).manual_seed(0)
        return self.model.nll_bound(self._prep(images), generator, samples, bound,
                                    self._labels(y_onehot))
