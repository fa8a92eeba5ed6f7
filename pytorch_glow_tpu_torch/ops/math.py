"""Diagonal-Gaussian density math and the bits/dim objective.

Counterpart of `pytorch_glow_tpu/ops/math.py`.  Layout is NHWC; `logs` is
log-standard-deviation; per-example reductions keep the batch axis.

`true_f32` pins cuDNN convolutions and cuBLAS products to true f32 (no
TF32) for the ops it wraps, whatever the process's flags say: the JAX
package runs its f32 convs and matmuls at HIGHEST precision.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

LOG2PI = math.log(2.0 * math.pi)


_pin_lock = threading.Lock()
_pin_depth = 0
_pin_saved = (False, False)


@contextlib.contextmanager
def true_f32():
    """A block (or, as a decorator, a function) in which cuDNN convs and
    cuBLAS products of f32 tensors run in true f32: a TF32 flag that is on
    (`torch.backends.cudnn.allow_tf32`, PyTorch's default, or
    `torch.backends.cuda.matmul.allow_tf32`) is switched off, and back on
    when the outermost block exits.  Only these per-backend flags are read
    and set: PyTorch refuses to read the process-wide matmul precision once
    they have been set.  The flags are process-wide, so the blocks of all
    threads share one pin under a lock and a depth count: a thread that
    leaves its block while another is still inside leaves the flags off.
    bf16 ops are unaffected."""
    global _pin_depth, _pin_saved
    with _pin_lock:
        if _pin_depth == 0:
            _pin_saved = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
            if _pin_saved[0]:
                torch.backends.cudnn.allow_tf32 = False
            if _pin_saved[1]:
                torch.backends.cuda.matmul.allow_tf32 = False
        _pin_depth += 1
    try:
        yield
    finally:
        with _pin_lock:
            _pin_depth -= 1
            if _pin_depth == 0:
                if _pin_saved[0]:
                    torch.backends.cudnn.allow_tf32 = True
                if _pin_saved[1]:
                    torch.backends.cuda.matmul.allow_tf32 = True


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
