"""Inferer: the serving entry point (NLL, sampling, encode/decode,
reconstruct, attribute manipulation, interpolation).

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

The attribute workflow (the reference's CelebA one): `compute_attribute_delta`
is the mean z_L of the images with each attribute minus the mean of those
without it, over batches carrying "attr" (+-1) or class "label"s (one
attribute per class, one-vs-rest); `manipulate` moves an image's z_L by
`strength` times one attribute's delta and decodes; `interpolate` and
`interpolate_full` decode straight lines between two images' latents.
Deltas are saved as `.npz` with the JAX package's keys ("delta", "names"),
so either package reads the other's file.  Decoding without a generator
draws the split halves from one seeded 0 on the model's device.

On a model set on a spatially sharded mesh (`Glow.set_mesh`), every call
runs its sharded levels on row slabs over the model group, every rank of
the group calling it with the same images; results are whole on every
rank.
"""

from __future__ import annotations

import os
from collections.abc import Iterable

import numpy as np
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

    def _generator(self, generator: torch.Generator | None) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.model.device).manual_seed(0)
        return generator

    @torch.no_grad()
    def decode(self, z: torch.Tensor, generator: torch.Generator | None = None,
               temperature: float = 0.0) -> torch.Tensor:
        """z_L -> uint8 images; split halves drawn at `temperature` (0.0 =
        the prior means)."""
        z = torch.as_tensor(z).to(self.model.device)
        return self.model.postprocess(
            self.model.decode(z, self._generator(generator), temperature))

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
        return self.model.nll_bound(self._prep(images), self._generator(generator), samples,
                                    bound, self._labels(y_onehot))

    # -- attribute manipulation -------------------------------------------------

    def compute_attribute_delta(self, batches: Iterable[dict], num_batches: int | None = None,
                                num_classes: int | None = None) -> torch.Tensor:
        """Mean z_L over the images with each attribute minus the mean over
        those without it: (A, *z_shape) f32 on the CPU.

        `batches` yields {"image": uint8 (B,H,W,C), "attr": (B, A) in +-1}
        or {"image", "label": (B,) class ids}, each class then one binary
        attribute (one-vs-rest; row i moves a latent toward class i), with
        `num_classes` classes (default `cfg.y_classes`).  Sums run in f64."""
        k = num_classes or self.cfg.y_classes
        dev = self.model.device
        sum_with = sum_without = n_with = n_without = None
        for seen, batch in enumerate(batches):
            if num_batches is not None and seen >= num_batches:
                break
            if "attr" in batch:
                attr = torch.as_tensor(batch["attr"]).to(dev) > 0  # (B, A)
            else:
                label = torch.as_tensor(batch["label"]).to(dev).long()
                if int(label.max()) >= k:
                    raise ValueError(f"label {int(label.max())} >= num_classes {k}; pass "
                                     f"num_classes (CLI: --set glow.y_classes=N)")
                attr = label[:, None] == torch.arange(k, device=dev)
            z = self.encode(batch["image"]).double()
            flat = z.reshape(z.shape[0], -1)
            if sum_with is None:
                sum_with = torch.zeros(attr.shape[1], flat.shape[1], dtype=torch.float64,
                                       device=dev)
                sum_without = torch.zeros_like(sum_with)
                n_with = torch.zeros(attr.shape[1], dtype=torch.float64, device=dev)
                n_without = torch.zeros_like(n_with)
            sum_with += attr.double().T @ flat
            sum_without += (~attr).double().T @ flat
            n_with += attr.sum(0)
            n_without += (~attr).sum(0)
        mean_with = sum_with / n_with.clamp_min(1)[:, None]
        mean_without = sum_without / n_without.clamp_min(1)[:, None]
        delta = (mean_with - mean_without).float().cpu()
        return delta.reshape(delta.shape[0], *self.cfg.final_latent_shape)

    @staticmethod
    def save_attribute_delta(path: str, delta, names: list[str] | None = None) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, delta=np.asarray(torch.as_tensor(delta).cpu(), np.float32),
                 names=np.asarray(names or [], dtype=object))

    @staticmethod
    def load_attribute_delta(path: str) -> torch.Tensor:
        return torch.from_numpy(np.load(path, allow_pickle=True)["delta"])

    def apply_attribute_delta(self, z: torch.Tensor, delta, attr_idx: int,
                              strength: float) -> torch.Tensor:
        """z' = z + strength * delta[attr_idx] (the reference's semantics)."""
        z = torch.as_tensor(z).to(self.model.device)
        return z + strength * torch.as_tensor(delta[attr_idx]).to(z.device)

    def manipulate(self, images, delta, attr_idx: int, strength: float,
                   temperature: float = 0.0) -> torch.Tensor:
        z = self.apply_attribute_delta(self.encode(images), delta, attr_idx, strength)
        return self.decode(z, temperature=temperature)

    # -- latent interpolation -------------------------------------------------

    def _lerp_weights(self, steps: int) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, steps, device=self.model.device)[:, None, None, None]

    def interpolate(self, img_a, img_b, steps: int = 8,
                    temperature: float = 0.0) -> torch.Tensor:
        """A straight line in z_L between two images -> (steps, H, W, C) uint8."""
        za = self.encode(torch.as_tensor(img_a)[None])
        zb = self.encode(torch.as_tensor(img_b)[None])
        ts = self._lerp_weights(steps)
        return self.decode((1.0 - ts) * za + ts * zb, temperature=temperature)

    def interpolate_full(self, img_a, img_b, steps: int = 8) -> torch.Tensor:
        """A straight line in the full latent (z_L and every split half): the
        endpoints reproduce the inputs (the exact round-trip)."""
        za, sa = self.encode_full(torch.as_tensor(img_a)[None])
        zb, sb = self.encode_full(torch.as_tensor(img_b)[None])
        ts = self._lerp_weights(steps)

        def lerp(a, b):
            return (1.0 - ts) * a + ts * b

        return self.decode_full(lerp(za, zb), [lerp(a, b) for a, b in zip(sa, sb)])
