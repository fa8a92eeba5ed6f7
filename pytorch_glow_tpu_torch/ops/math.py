"""Diagonal-Gaussian density math and the bits/dim objective.

Counterpart of `pytorch_glow_tpu/ops/math.py`.  Layout is NHWC; `logs` is
log-standard-deviation; per-example reductions keep the batch axis.
"""

from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def gaussian_likelihood(mean: torch.Tensor, logs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(x; mean, exp(logs)^2)."""
    inv_var = torch.exp(-2.0 * logs)
    return -0.5 * (LOG2PI + 2.0 * logs + torch.square(x - mean) * inv_var)


def gaussian_logp(mean: torch.Tensor, logs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-example log-probability: sum of `gaussian_likelihood` over H,W,C."""
    lik = gaussian_likelihood(mean, logs, x)
    return lik.sum(dim=tuple(range(1, lik.ndim)))


def gaussian_sample(
    mean: torch.Tensor,
    logs: torch.Tensor,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
    shape: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Temperature sampling: mean + exp(logs) * eps * temperature."""
    if shape is None:
        shape = torch.broadcast_shapes(mean.shape, logs.shape)
    eps = torch.randn(shape, generator=generator, dtype=mean.dtype, device=mean.device)
    return mean + torch.exp(logs) * eps * temperature


def num_dims(shape: tuple[int, ...]) -> int:
    """Dimensionality D = C*H*W of one image (batch axis excluded)."""
    d = 1
    for s in shape[1:]:
        d *= s
    return d


def bits_per_dim(objective: torch.Tensor, dims: int) -> torch.Tensor:
    """nll in bits/dim = -objective / (ln 2 * D)."""
    return -objective / (math.log(2.0) * dims)


def discretization_correction(dims: int, n_bins: float) -> float:
    """-D * log(n_bins): converts continuous density to discrete log-mass."""
    return -dims * math.log(n_bins)
