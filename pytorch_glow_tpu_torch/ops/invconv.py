"""Invertible 1x1 convolution math, all f32: the LU parameterisation and
the plain (C, C) weight.

Counterpart of `pytorch_glow_tpu/ops/invconv_xla.py` and of the plain kind
in `pytorch_glow_tpu/models/layers.py` (`permutation_forward` /
`permutation_reverse`):

* W = P @ L @ (U + diag(sign_s * exp(log_s))), stored as (L@U')[p_idx]
  with P @ M == M[p_idx];
* log|det W| = sum(log_s);
* W^{-1} = U'^{-1} L^{-1} P^T by two triangular solves, P^T applied as a
  column gather by p_idx;
* the mix over a pixel batch is y = x @ W^T;
* a plain W starts as a random rotation, its log|det| is slogdet's and
  its inverse `torch.linalg.inv`'s.

Every product and solve here runs in true f32 whatever the process's TF32
flags say (`ops/math.true_f32`): the logdet and the exact round-trip depend
on the mix's accuracy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytorch_glow_tpu_torch.ops.math import true_f32


def random_rotation(c: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """A random orthonormal (C, C) f32 matrix: QR of a standard normal,
    columns sign-fixed by diag(R) (the reference init), row-major (QR
    returns Q column-major)."""
    w = torch.randn(c, c, generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(w)
    return (q * torch.sign(torch.diagonal(r))[None, :]).contiguous()


@true_f32()
def plain_logdet(w: torch.Tensor) -> torch.Tensor:
    """log|det W| of a plain weight."""
    return torch.linalg.slogdet(w.float())[1]


@true_f32()
def plain_inverse(w: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(w.float())


class LUParams(NamedTuple):
    p_idx: torch.Tensor  # (C,) int64, P @ M == M[p_idx]
    l_raw: torch.Tensor  # (C, C) f32, strictly-lower part used
    u_raw: torch.Tensor  # (C, C) f32, strictly-upper part used
    log_s: torch.Tensor  # (C,) f32
    sign_s: torch.Tensor  # (C,) f32, +-1


def lu_factors(p: LUParams) -> tuple[torch.Tensor, torch.Tensor]:
    c = p.log_s.shape[0]
    eye = torch.eye(c, dtype=torch.float32, device=p.log_s.device)
    lower = torch.tril(p.l_raw.float(), -1) + eye
    upper = torch.triu(p.u_raw.float(), 1) + torch.diag(p.sign_s.float() * torch.exp(p.log_s.float()))
    return lower, upper


@true_f32()
def lu_assemble(p: LUParams) -> torch.Tensor:
    """W (C, C) f32 from the LU factors."""
    lower, upper = lu_factors(p)
    return (lower @ upper)[p.p_idx.long()]


def lu_logdet(p: LUParams) -> torch.Tensor:
    """log|det W| = sum(log_s)."""
    return p.log_s.float().sum()


@true_f32()
def lu_inverse(p: LUParams) -> torch.Tensor:
    """W^{-1} (C, C) f32 via two triangular solves and a column permutation."""
    lower, upper = lu_factors(p)
    eye = torch.eye(lower.shape[0], dtype=torch.float32, device=lower.device)
    l_inv = torch.linalg.solve_triangular(lower, eye, upper=False, unitriangular=True)
    w_inv_pt = torch.linalg.solve_triangular(upper, l_inv, upper=True)
    return w_inv_pt[:, p.p_idx.long()]


@true_f32()
def mix_channels(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., j] = sum_i x[..., i] * w[j, i], in f32."""
    return x.float() @ w.float().T
