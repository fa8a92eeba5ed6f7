"""A plain f32 Glow (Kingma & Dhariwal 2018, arXiv:1807.03039) over a
lineage `state_dict`: the benchmark's reference.

Plain `torch` operations on a dict of tensors; it imports nothing of the
program and derives everything the program derives again: the 1x1 mixes
from their LU factors, the data-dependent actnorm init, the losses, the
gradients and the samples.  Layout NHWC.  Each flow step: actnorm, LU 1x1
conv W = P L U (L unit lower, U = strict upper + diag(sign * exp(log_s))),
then an additive or affine coupling whose net is conv3x3 -> actnorm ->
ReLU -> conv1x1 -> actnorm -> ReLU -> conv3x3 (+ bias) * exp(3 logs); the
affine coupling's shift and raw scale are the net's even and odd outputs,
scale = sigmoid(raw + 2).  A split scores the second half of the channels
under a Gaussian whose mean and log-std are the even and odd outputs of a
conv of the first half; the top prior's are the halves of
bias * exp(3 logs).  bits/dim = -(log-density - D log n_bins) / (D ln 2).

Precision: everything in f32 with TF32 off (`exact`), the mix's inverse in
f64.  `quant`, where given, rounds the coupling net's conv operands first:
the control (`fp8`, scaled e4m3, the step below the program's bf16 net).

Memory: a batch runs in blocks of `rows` images; the training gradient
recomputes each step's activations in the backward (checkpointing), so a
block holds one step's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flowbench.counts import latent_shapes
from flowbench.weights import levels

LOG2PI = math.log(2.0 * math.pi)
ACTNORM_EPS = 1e-6
Quant = Callable[[torch.Tensor], torch.Tensor] | None


@contextlib.contextmanager
def exact():
    """f32 products and convs without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax to 448)."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def squeeze(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze(z: torch.Tensor) -> torch.Tensor:
    b, h, w, c4 = z.shape
    z = z.reshape(b, h, w, c4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return z.reshape(b, 2 * h, 2 * w, c4 // 4)


def conv(x: torch.Tensor, w: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """SAME stride-1 cross-correlation of NHWC x with an (out, in, k, k) w,
    as products over pixels: the k*k taps of x side by side times w where
    w has no more inputs than outputs, else x times each tap's w with the
    tap outputs added at their offsets (f32 GEMMs run far faster than f32
    convolutions with few channels on either side)."""
    if quant is not None:
        x, w = quant(x), quant(w)
    b, h, wd, c_in = x.shape
    c_out, k = w.shape[0], w.shape[-1]
    if k == 1:
        return x @ w.view(c_out, c_in).T
    p = k // 2
    if c_in <= c_out:
        xp = F.pad(x, (0, 0, p, p, p, p))
        taps = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(k) for dx in range(k)],
                         dim=-1)
        return taps @ w.permute(0, 2, 3, 1).reshape(c_out, k * k * c_in).T
    y = x @ w.permute(2, 3, 0, 1).reshape(k * k * c_out, c_in).T
    y = F.pad(y, (0, 0, p, p, p, p))
    out = 0
    for t in range(k * k):
        dy, dx = divmod(t, k)
        out = out + y[:, dy:dy + h, dx:dx + wd, t * c_out:(t + 1) * c_out]
    return out


def actnorm(x: torch.Tensor, P: dict, p: str) -> torch.Tensor:
    return (x + P[p + "bias"].view(-1)) * torch.exp(P[p + "logs"].view(-1))


def zero_conv(x: torch.Tensor, P: dict, p: str, quant: Quant = None) -> torch.Tensor:
    y = conv(x, P[p + "weight"], quant) + P[p + "bias"]
    return y * torch.exp(3.0 * P[p + "logs"].view(-1))


def mix(P: dict, p: str) -> torch.Tensor:
    """W = P L U of one step's LU 1x1 conv, (C, C), y = x @ W.T."""
    lower = torch.tril(P[p + "invconv.lower"], -1) + torch.eye(
        P[p + "invconv.lower"].shape[0], device=P[p + "invconv.lower"].device)
    upper = torch.triu(P[p + "invconv.upper"], 1) + torch.diag(
        P[p + "invconv.sign_s"] * torch.exp(P[p + "invconv.log_s"]))
    return P[p + "invconv.p"] @ lower @ upper


def net(z1: torch.Tensor, P: dict, p: str, quant: Quant, ddi: bool = False) -> torch.Tensor:
    h = conv(z1, P[p + "f.0.weight"], quant)
    if ddi:
        init_actnorm(h, P, p + "f.0.actnorm.", 1.0)
    h = torch.relu(actnorm(h, P, p + "f.0.actnorm."))
    h = conv(h, P[p + "f.2.weight"], quant)
    if ddi:
        init_actnorm(h, P, p + "f.2.actnorm.", 1.0)
    h = torch.relu(actnorm(h, P, p + "f.2.actnorm."))
    return zero_conv(h, P, p + "f.4.", quant)


@torch.no_grad()
def init_actnorm(x: torch.Tensor, P: dict, p: str, scale: float) -> None:
    """Data-dependent init: bias = -mean, logs = log(scale / (std + eps))
    over (B, H, W)."""
    mean = x.mean(dim=(0, 1, 2))
    std = torch.sqrt(torch.square(x - mean).mean(dim=(0, 1, 2)))
    P[p + "bias"].copy_(-mean.view_as(P[p + "bias"]))
    P[p + "logs"].copy_(torch.log(scale / (std + ACTNORM_EPS)).view_as(P[p + "logs"]))


def step_forward(z, logdet, P: dict, p: str, affine: bool, quant: Quant,
                 ddi: bool = False, actnorm_scale: float = 1.0):
    hw = z.shape[1] * z.shape[2]
    if ddi:
        init_actnorm(z, P, p + "actnorm.", actnorm_scale)
    z = actnorm(z, P, p + "actnorm.")
    z = z @ mix(P, p).T
    logdet = logdet + hw * (P[p + "actnorm.logs"].sum() + P[p + "invconv.log_s"].sum())
    c = z.shape[-1] // 2
    z1, z2 = z[..., :c], z[..., c:]
    h = net(z1, P, p, quant, ddi)
    if affine:
        raw = h[..., 1::2] + 2.0
        z2 = (z2 + h[..., 0::2]) * torch.sigmoid(raw)
        logdet = logdet + F.logsigmoid(raw).sum(dim=(1, 2, 3))
    else:
        z2 = z2 + h
    return torch.cat([z1, z2], dim=-1), logdet


def step_reverse(z, P: dict, p: str, affine: bool, quant: Quant):
    c = z.shape[-1] // 2
    z1, z2 = z[..., :c], z[..., c:]
    h = net(z1, P, p, quant)
    if affine:
        z2 = z2 / torch.sigmoid(h[..., 1::2] + 2.0) - h[..., 0::2]
    else:
        z2 = z2 - h
    w_inv = torch.linalg.inv(mix(P, p).double()).float()
    z = torch.cat([z1, z2], dim=-1) @ w_inv.T
    return z * torch.exp(-P[p + "actnorm.logs"].view(-1)) - P[p + "actnorm.bias"].view(-1)


def gaussian_logp(mean, logs, x) -> torch.Tensor:
    lik = -0.5 * (LOG2PI + 2.0 * logs + torch.square(x - mean) * torch.exp(-2.0 * logs))
    return lik.sum(dim=(1, 2, 3))


def split_prior(z1, P: dict, p: str):
    h = zero_conv(z1, P, p + "conv.")
    return h[..., 0::2], h[..., 1::2]


def top_prior(P: dict, glow: dict, device):
    c = latent_shapes(glow)[-1][2]
    h = torch.zeros(2 * c, device=device)
    if glow["learn_top"]:
        h = h + P["learn_top.bias"] * torch.exp(3.0 * P["learn_top.logs"].view(-1))
    return h[:c], h[c:]


def preprocess(x_u8: torch.Tensor, glow: dict) -> torch.Tensor:
    """uint8 -> [0, 1) at n_bits_x bits."""
    x = x_u8.float()
    n_bits = glow["n_bits_x"]
    if n_bits < 8:
        return torch.floor(x / 2 ** (8 - n_bits)) / 2 ** n_bits
    return x / 256.0


def dims(glow: dict) -> int:
    return math.prod(glow["image_shape"])


def nll(x: torch.Tensor, P: dict, glow: dict, quant: Quant = None, ddi: bool = False,
        remat: bool = False) -> torch.Tensor:
    """bits/dim of each image of a [0, 1) batch (dequantized by the caller,
    or at the bin corner).  `ddi` sets every actnorm of the flow from the
    batch on the way; `remat` recomputes each step in the backward."""
    affine = glow["flow_coupling"] == "affine"
    d = dims(glow)
    logdet = torch.full((x.shape[0],), -d * math.log(2 ** glow["n_bits_x"]), device=x.device)
    z = x
    for steps, split in levels(glow):
        z = squeeze(z)
        for p in steps:
            def step(z, logdet, p=p):
                return step_forward(z, logdet, P, p, affine, quant, ddi, glow["actnorm_scale"])
            if remat:  # the step's weights reach it by closure, not as arguments
                z, logdet = checkpoint(step, z, logdet, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                z, logdet = step(z, logdet)
        if split is not None:
            c = z.shape[-1] // 2
            z, z2 = z[..., :c], z[..., c:]
            logdet = logdet + gaussian_logp(*split_prior(z, P, split), z2)
    mean, logs = top_prior(P, glow, x.device)
    logdet = logdet + gaussian_logp(mean, logs, z)
    return -logdet / (d * math.log(2.0))


def sample(noise: list[torch.Tensor], temperature: float, P: dict, glow: dict,
           quant: Quant = None) -> torch.Tensor:
    """[0, 1)-scale images from standard normal draws: the top latent's,
    then each split's, the deepest first."""
    affine = glow["flow_coupling"] == "affine"
    mean, logs = top_prior(P, glow, noise[0].device)
    z = mean + torch.exp(logs) * noise[0] * temperature
    draws = iter(noise[1:])
    for steps, split in reversed(levels(glow)):
        if split is not None:
            m, lg = split_prior(z, P, split)
            z = torch.cat([z, m + torch.exp(lg) * next(draws) * temperature], dim=-1)
        for p in reversed(steps):
            z = step_reverse(z, P, p, affine, quant)
        z = unsqueeze(z)
    return z


def blocks(n: int, rows: int):
    return [slice(i, min(n, i + rows)) for i in range(0, n, rows)]


@torch.no_grad()
def sample_batched(noise: list[torch.Tensor], temperature: float, P: dict, glow: dict,
                   rows: int, quant: Quant = None) -> torch.Tensor:
    with exact():
        return torch.cat([sample([n[s] for n in noise], temperature, P, glow, quant)
                          for s in blocks(noise[0].shape[0], rows)])


@torch.no_grad()
def ddi(x: torch.Tensor, P: dict, glow: dict) -> None:
    """Sets the flow's actnorms (and the coupling nets') in place from one
    dequantized batch, in depth order."""
    with exact():
        nll(x, P, glow, ddi=True)


def loss_and_grads(x: torch.Tensor, P: dict, names: list[str], glow: dict, rows: int,
                   quant: Quant = None) -> tuple[float, dict[str, torch.Tensor]]:
    """The batch's mean bits/dim and its gradient by the named leaves,
    summed over blocks of `rows` images."""
    leaves = {n: P[n].detach().requires_grad_(True) for n in names}
    Q = {**P, **leaves}
    grads = {n: torch.zeros_like(P[n]) for n in names}
    total = 0.0
    with exact():
        for s in blocks(x.shape[0], rows):
            loss = nll(x[s], Q, glow, quant, remat=True).sum() / x.shape[0]
            for n, g in zip(names, torch.autograd.grad(loss, list(leaves.values()),
                                                       allow_unused=True)):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
    return total, grads
