"""Variational dequantization: a learned q(u|x) instead of uniform noise.

Counterpart of `pytorch_glow_tpu/models/vardeq.py` (Flow++, Ho et al.
2019, arXiv:1902.00275 §3.1).  For any density q(u|x) on (0,1)^D,

    log P(x) >= E_{u~q}[ log p(x + u/n_bins) ] - D log n_bins - E_q[log q(u|x)],

and `VarDeq` supplies the noise u and the -log q(u|x) term.  eps is a
Logistic(0,1) draw (the logit of a uniform one), w = flow(eps; ctx(x)) is
`vardeq_steps` additive couplings and a final affine, u = sigmoid(w), and

    log q(u|x) = log p_L(eps) - logdet_flow - sum log sigmoid'(w).

The flow runs on squeeze2d'd tensors (C -> 4C at H/2); the context (two
3x3 `Conv2d`s with their actnorms, each followed by a ReLU, over
squeeze2d(x)) is computed once and concatenated into every coupling's
input.  Every coupling's net ends in a zero-init conv, so the flow is the
identity at init and q is exactly uniform there: `base` rides through the
same channel flips as `w`, and the per-element difference of the two
log-density terms is formed before the sum, so `neg_log_q` is exactly 0 at
init under any reduction order.  Everything runs in f32 (true f32 on the
card); only the forward direction exists.

The draw is apart from the transform: `draw_uniform` takes the caller's
generator, `forward_from_uniform` the uniform draw, so a test can hand the
port the JAX package's own draw.

`state_dict` names (the lineage has no vardeq, so these are the port's):
`ctx.conv1.weight`, `ctx.conv1.actnorm.{bias,logs}`, the same for
`ctx.conv2`, `steps.{i}.{0,2}.weight` and `.actnorm.{bias,logs}`,
`steps.{i}.4.{weight,bias,logs}` (the coupling net of `layers.coupling_net`),
and the final `bias` and `logs` (4C each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_glow_tpu_torch.config import GlowConfig
from pytorch_glow_tpu_torch.models.layers import Conv2d, coupling_net
from pytorch_glow_tpu_torch.ops.reshape import cat_channel, split_channel, squeeze2d, unsqueeze2d

UNIFORM_LOW = 1e-5  # the draw is U(1e-5, 1 - 1e-5): eps stays finite (about +-11.5)


def _log_dsigmoid(v: torch.Tensor) -> torch.Tensor:
    """log sigmoid'(v) = log sigmoid(v) + log sigmoid(-v), stable at any |v|."""
    return F.logsigmoid(v) + F.logsigmoid(-v)


def draw_uniform(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """U(1e-5, 1 - 1e-5) in f32 from `generator`, as the JAX package's
    `uniform(key, shape, f32, 1e-5, 1 - 1e-5)` scales its draw."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (1.0 - 2 * UNIFORM_LOW) + UNIFORM_LOW


class _Context(nn.Module):
    def __init__(self, c: int, width: int, generator: torch.Generator | None):
        super().__init__()
        self.conv1 = Conv2d(c, width, 3, generator)
        self.conv2 = Conv2d(width, width, 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv1(squeeze2d(x.float(), 2)))
        return torch.relu(self.conv2(h))


class VarDeq(nn.Module):
    def __init__(self, cfg: GlowConfig, generator: torch.Generator | None = None):
        super().__init__()
        cs = 4 * cfg.image_shape[2]  # channels after squeeze2d
        ctx_w = cfg.vardeq_context_width
        self.n_bins = cfg.n_bins
        self.ctx = _Context(cs, ctx_w, generator)
        self.steps = nn.ModuleList(
            coupling_net(cs // 2 + ctx_w, cfg.vardeq_width, cs // 2, generator)
            for _ in range(cfg.vardeq_steps))
        self.bias = nn.Parameter(torch.zeros(cs))
        self.logs = nn.Parameter(torch.zeros(cs))

    def forward_from_uniform(self, x: torch.Tensor, u0: torch.Tensor):
        """(x_deq, -log q(u|x)) for the uniform draw `u0` (x's shape):
        x_deq = x + u / n_bins with u ~ q(u|x)."""
        eps = torch.log(u0) - torch.log1p(-u0)
        w = squeeze2d(eps, 2)
        base = w
        ctx = self.ctx(x)
        for i, net in enumerate(self.steps):
            if i % 2:
                # Alternate which half is transformed: a fixed channel flip.
                w, base = w.flip(-1), base.flip(-1)
            w1, w2 = split_channel(w, "simple")
            w = cat_channel(w1, w2 + net(torch.cat([w1, ctx], dim=-1)), "simple")
        w = w * torch.exp(self.logs) + self.bias
        log_q = (_log_dsigmoid(base) - _log_dsigmoid(w)).sum(dim=(1, 2, 3))
        log_q = log_q - w.shape[1] * w.shape[2] * self.logs.sum()  # - logdet of the flow
        u = unsqueeze2d(torch.sigmoid(w), 2)
        return x + u / self.n_bins, -log_q

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """(x_deq, -log q(u|x)) with the uniform draw taken from `generator`."""
        return self.forward_from_uniform(x, draw_uniform(x.shape, generator, x.device))
