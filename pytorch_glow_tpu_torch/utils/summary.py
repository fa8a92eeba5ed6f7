"""Model summary: the parameter count and an analytic FLOPs-per-image
estimate.

A torch copy of `pytorch_glow_tpu/utils/summary.py` (`param_count`,
`forward_flops_per_image`, `summarize`); the trainer prints `summarize` at
its start.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from pytorch_glow_tpu_torch.config import GlowConfig


def param_count(params: nn.Module | Iterable[torch.Tensor]) -> int:
    """Elements of a model's parameters (or of the given tensors)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    return sum(p.numel() for p in params)


def forward_flops_per_image(cfg: GlowConfig) -> int:
    """Analytic MAC*2 count of one forward pass (the coupling nets' convs and
    the 1x1 mixes); elementwise work (actnorm, sigmoid, prior logp) is
    excluded."""
    total = 0
    hidden = cfg.hidden_channels
    for h, w, c in cfg.latent_shapes():
        c_half = c // 2
        c_out = c_half if cfg.flow_coupling == "additive" else c
        per_pixel = 9 * c_half * hidden + hidden * hidden + 9 * hidden * c_out
        if cfg.flow_permutation == "invconv":
            per_pixel += c * c
        total += 2 * cfg.K * h * w * per_pixel
    return total


def summarize(model: nn.Module, cfg: GlowConfig) -> str:
    n = param_count(model)
    gf = forward_flops_per_image(cfg) / 1e9
    return (f"Glow K={cfg.K} L={cfg.L} width={cfg.hidden_channels} "
            f"{cfg.image_shape[0]}x{cfg.image_shape[1]}: {n / 1e6:.1f}M params, "
            f"~{gf:.1f} GFLOP/image forward")
