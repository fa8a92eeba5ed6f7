"""The traffic's images: one generator for every mix, driven by the mix's
"images" parameters and the run's seed.

Each image is a mean level, a smooth field (normal draws on a coarse grid,
bilinearly upsampled to the image) and pixel noise, each image with its
own level, contrast and noise drawn uniformly from the mix's ranges, so
that images differ in how much they cost the model (their bits/dim) as
photographs do.  A mix holds a pool of distinct batches that its calls
cycle through.  Drawn on the device in a few calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowbench import weights


@torch.no_grad()
def pool(spec: dict, image_shape, batch: int, seed: int, device) -> torch.Tensor:
    """(spec["pool"], batch, H, W, C) uint8 images."""
    n = spec["pool"] * batch
    h, w, c = image_shape
    gen = weights.generator(device, seed, weights.IMAGES)

    def uniform(lo_hi, shape=(n, 1, 1, 1)):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    g = spec["coarse"]
    field = torch.randn(n, c, g, g, generator=gen, device=device)
    field = F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)
    x = (uniform(spec["level"]) + uniform(spec["contrast"]) * field.permute(0, 2, 3, 1)
         + uniform(spec["noise"]) * torch.randn(n, h, w, c, generator=gen, device=device))
    x = torch.clamp(torch.round(255.0 * x), 0, 255).to(torch.uint8)
    return x.view(spec["pool"], batch, h, w, c)


def ddi_noise(batch: torch.Tensor, seed: int, device) -> torch.Tensor:
    """U[0, 1) dequantization noise for the batch that sets the actnorms
    (data-dependent init), from the seed."""
    gen = weights.generator(device, seed, weights.DDI_NOISE)
    return torch.rand(batch.shape, generator=gen, device=device)
