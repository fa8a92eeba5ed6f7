"""Invertible flow layers as `nn.Module`s: the unfused path.

Counterpart of `pytorch_glow_tpu/models/layers.py` (its `flowstep_impl=
"xla"` math at `cfg.compute_dtype`).  Parameter names and shapes are the
reference lineage's `state_dict` (`pytorch_glow_tpu/utils/torch_migrate.py`
key table), so `utils/convert.state_dict_from_jax` output loads directly.

Public tensors are NHWC.  Convolutions permute to NCHW around `F.conv2d`;
lineage conv weights are (out, in, kh, kw), cross-correlation like JAX's
HWIO convs, so nothing is flipped.

Precision: an f32 conv runs in true f32 whatever the process's TF32 flags
say (`ops/math.true_f32`, per op, so a library caller gets it too; PyTorch
lets cuDNN use TF32 by default), as the JAX package runs its f32 convs at
HIGHEST: the split priors and the whole coupling net at
`compute_dtype="float32"`.  The f32 channel mixes of `ops/invconv.py` and
`LinearZeros` are pinned the same way.  The bf16 coupling net's first two
convs take cuDNN's bf16 path; its zero conv sums its bf16 operands in true
f32 (`Conv2dZeros`).

ActNorm's data-dependent init: while `ActNorm.ddi` is True, a forward call
sets the module's parameters from the batch statistics of its input and then
applies them (`Glow.ddi_init` switches it on for one encode).  With groups
(`ActNorm.groups`, set by `Glow.ddi_init` on a mesh: the data group, and
on a spatially sharded level the model group too) the statistics are the
global batch's, as the JAX reductions are under pjit: the mean
all-reduced over each group (every rank holds as many pixels), then the
variance about that mean, so every replica derives the same parameters.

Spatial sharding (`parallel/spatial.py`): on a sharded level the model
sets `halo` on its 3x3 convs (the coupling nets' conv1 and zero conv, the
split prior): `halo(x, 1)` gives the row slab with one row of each
neighbouring rank around it (zeros beyond the image, the SAME padding's
rows), the conv runs on that and keeps the slab's own output rows.  DDI's
statistics there reduce over the model group's pixels too
(`ActNorm.groups`).

Tensor parallelism (`CouplingNet.model_group`, set by
`parallel/mesh.shard_model`): the coupling net's conv1 holds its slice of
the hidden channels (column-parallel, its actnorm local) and conv2 its
slice of their inputs (row-parallel): its partial products are summed over
the model group in f32, then its actnorm and the zero conv run replicated.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_glow_tpu_torch.ops import invconv as ic
from pytorch_glow_tpu_torch.ops import invconv_fused as icf
from pytorch_glow_tpu_torch.ops.math import gaussian_logp, gaussian_sample, true_f32
from pytorch_glow_tpu_torch.ops.reshape import cat_channel, split_channel, squeeze2d, unsqueeze2d
from pytorch_glow_tpu_torch.parallel import distributed as pd

ACTNORM_EPS = 1e-6
LOGSCALE_FACTOR = 3.0


def _halo_conv(conv, x: torch.Tensor, halo) -> torch.Tensor:
    """`conv(x)`, or on a row slab (`halo` given) the slab's own rows of
    `conv` over the slab with one row of each neighbour."""
    if halo is None:
        return conv(x)
    return conv(halo(x, 1))[:, 1:-1]


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv of NHWC `x` with an (out, in, kh, kw) weight;
    true f32 for an f32 `x`."""
    xt, w = x.permute(0, 3, 1, 2), w.to(x.dtype)
    if x.dtype == torch.float32:
        with true_f32():
            y = F.conv2d(xt, w, padding=w.shape[-1] // 2)
    else:
        y = F.conv2d(xt, w, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


class ActNorm(nn.Module):
    """y = (x + bias) * exp(logs); logdet += H*W*sum(logs)."""

    def __init__(self, c: int, scale: float = 1.0):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.logs = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.scale = scale
        self.ddi = False
        self.groups = ()  # the groups DDI's statistics reduce over

    @torch.no_grad()
    def ddi_(self, x: torch.Tensor) -> None:
        """bias = -mean, logs = log(scale / (std + eps)) over (B, H, W), of
        the global batch under its groups (as many pixels on every rank)."""
        x32 = x.float()
        mean = x32.mean(dim=(0, 1, 2))
        for group in self.groups:
            pd.mean_(mean, group)
        var = torch.square(x32 - mean).mean(dim=(0, 1, 2))
        for group in self.groups:
            pd.mean_(var, group)
        std = torch.sqrt(var)
        self.bias.copy_((-mean).view_as(self.bias))
        self.logs.copy_(torch.log(self.scale / (std + ACTNORM_EPS)).view_as(self.logs))

    def forward(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        if self.ddi:
            self.ddi_(x)
        bias = self.bias.view(-1).to(x.dtype)
        logs = self.logs.view(-1).to(x.dtype)
        y = (x + bias) * torch.exp(logs)
        if logdet is not None:
            logdet = logdet + x.shape[1] * x.shape[2] * self.logs.sum()
        return y, logdet

    def reverse(self, y: torch.Tensor) -> torch.Tensor:
        bias = self.bias.view(-1).to(y.dtype)
        logs = self.logs.view(-1).to(y.dtype)
        return y * torch.exp(-logs) - bias


class Conv2d(nn.Module):
    """N(0, 0.05) conv without bias, then an output actnorm (no logdet)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            0.05 * torch.randn(c_out, c_in, kernel, kernel, generator=generator)
        )
        self.actnorm = ActNorm(c_out)
        self.halo = None  # a row slab's exchange (module docstring)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.actnorm(_halo_conv(lambda t: _conv_nhwc(t, self.weight), x, self.halo))
        return y


def _tap_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv of NHWC bf16 `x` with a bf16 (out, in, k,
    k) weight on the card, as the f32 sum of the bf16 products: one bf16
    product to k*k*out tap columns with an f32 result
    (`torch.mm(..., out_dtype=float32)`), then each tap's columns added, in
    f32, at its offset (the fused step's tap-packed zero conv)."""
    b, h, wd, c_in = x.shape
    c_out, k = w.shape[0], w.shape[-1]
    p = k // 2
    packed = w.permute(2, 3, 0, 1).reshape(k * k * c_out, c_in)
    taps = torch.mm(x.reshape(-1, c_in), packed.T, out_dtype=torch.float32)
    taps = F.pad(taps.view(b, h, wd, k * k * c_out), (0, 0, p, p, p, p))
    out = taps[:, :h, :wd, :c_out]  # tap t = k * dy + dx reads rows i + dy - p
    for t in range(1, k * k):
        dy, dx = divmod(t, k)
        out = out + taps[:, dy:dy + h, dx:dx + wd, t * c_out:(t + 1) * c_out]
    return out


class _ConvF32Sum(torch.autograd.Function):
    """A SAME conv of low-precision NHWC `x` and weight `w` whose output is
    the f32 sum of their products: on the card `_tap_sum`, on the CPU a
    true-f32 conv of the same operands.  The backward is the low-precision
    conv's, as the JAX package's autodiff of conv(bf16) -> astype(f32)
    runs it: the f32 cotangent rounded to the operands' dtype, then the
    conv's two transposes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return _tap_sum(x, w)
        return _conv_nhwc(x.float(), w.float())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        p = w.shape[-1] // 2
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [p, p],
            [1, 1], False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return None if gx is None else gx.permute(0, 2, 3, 1), gw


class Conv2dZeros(nn.Module):
    """Zero-init 3x3 conv, output (conv + bias) * exp(3 * logs) in f32.

    The operands are rounded to the input's dtype (the coupling net's
    compute dtype, or f32 for the priors).  A bf16 input gives the f32 sum
    of the bf16 operands (`_ConvF32Sum`), never a bf16-rounded result, as
    the jitted JAX conv (which folds its output's f32 cast into the conv)
    and the fused flow step give; an f32 one the true-f32 conv."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.logs = nn.Parameter(torch.zeros(c_out, 1, 1))
        self.halo = None  # a row slab's exchange (module docstring)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return _conv_nhwc(x, self.weight)
        return _ConvF32Sum.apply(x, self.weight.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _halo_conv(self._conv, x, self.halo)
        y = y + self.bias
        return y * torch.exp(self.logs.view(-1) * LOGSCALE_FACTOR)


class LinearZeros(nn.Module):
    """Zero-init linear layer, y = (x W^T + bias) * exp(3 * logs), in true
    f32; `weight` is (out, in), the lineage's layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.logs = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with true_f32():
            y = x.float() @ self.weight.T + self.bias
        return y * torch.exp(self.logs * LOGSCALE_FACTOR)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group backward
    (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return pd.all_reduce_(g.to(torch.float32, copy=True), ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group (in f32) forward;
    identity backward (the output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return pd.all_reduce_(x.float(), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class CouplingNet(nn.Sequential):
    """The coupling net f: Conv(3x3) -> ReLU -> Conv(1x1) -> ReLU ->
    Conv2dZeros(3x3), keys 0 / 2 / 4; it runs in its input's dtype.  With
    a `model_group` its conv1 and conv2 hold their shards of the hidden
    channels (module docstring)."""

    def __init__(self, c_in: int, hidden: int, c_out: int,
                 generator: torch.Generator | None = None):
        super().__init__(
            Conv2d(c_in, hidden, 3, generator), nn.ReLU(),
            Conv2d(hidden, hidden, 1, generator), nn.ReLU(),
            Conv2dZeros(hidden, c_out),
        )
        self.model_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return super().forward(x)
        conv1, conv2, conv3 = self[0], self[2], self[4]
        h = F.relu(conv1(_CopyToModel.apply(x, self.model_group)))
        h = _ReduceFromModel.apply(_conv_nhwc(h, conv2.weight), self.model_group)
        h, _ = conv2.actnorm(h)
        return conv3(F.relu(h))


def coupling_net(c_in: int, hidden: int, c_out: int,
                 generator: torch.Generator | None = None) -> CouplingNet:
    return CouplingNet(c_in, hidden, c_out, generator)


def _random_lu(c: int, generator: torch.Generator | None):
    """Fixed-P LU factors of a random rotation (Doolittle, partial pivoting,
    float64 on the host), as `invconv_xla.lu_init` computes them."""
    a = ic.random_rotation(c, generator).double().numpy().copy()
    perm = np.arange(c)
    for k in range(c - 1):
        piv = k + int(np.argmax(np.abs(a[k:, k])))
        if piv != k:
            a[[k, piv]] = a[[piv, k]]
            perm[[k, piv]] = perm[[piv, k]]
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    s = np.diag(a).copy()
    p_idx = np.empty(c, dtype=np.int64)
    p_idx[perm] = np.arange(c)
    return p_idx, np.tril(a, -1), np.triu(a, 1), np.log(np.abs(s)), np.sign(s)


# -- channel permutations -----------------------------------------------------
# Three kinds share one interface: forward(x, logdet) -> (y, logdet),
# reverse(z), matrix(reverse) -> the (C, C) f32 mix W (or W^-1) with
# y = x @ W^T, and logdet() -> log|det W| per pixel.  The fused flow step
# (`ops/flowstep.pack_weights`) takes any of them through `matrix`.


def _refresh_p_idx(module: "InvConv1x1LU", incompatible_keys) -> None:
    with torch.no_grad():
        module.p_idx.copy_(torch.argmax(module.p, dim=1))


class InvConv1x1LU(nn.Module):
    """LU-parameterised invertible 1x1 conv; P is one-hot, P[i, p_idx[i]] = 1.

    With `impl="pallas"` the mix runs through `ops/invconv_fused.py` (the
    kernels K6a / K6b on a CUDA tensor); with "xla" through the plain f32
    math of `ops/invconv.py`.  Both read only the strict triangles of
    `lower` / `upper`, so `lu_params` hands them over as they are (autograd
    gives the other entries zero grads); `p_idx` is kept beside `p`, out of
    the `state_dict` (whose names are the reference lineage's, `l_mask` and
    `eye` included), and refreshed from `p` on every `load_state_dict`."""

    def __init__(self, c: int, generator: torch.Generator | None = None, impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown invconv_impl: {impl}")
        self.impl = impl
        p_idx, lower, upper, log_s, sign_s = _random_lu(c, generator)
        p = torch.zeros(c, c)
        p[torch.arange(c), torch.from_numpy(p_idx)] = 1.0
        self.register_buffer("p", p)
        self.register_buffer("p_idx", torch.from_numpy(p_idx), persistent=False)
        self.register_load_state_dict_post_hook(_refresh_p_idx)
        self.register_buffer("sign_s", torch.tensor(sign_s, dtype=torch.float32))
        self.register_buffer("l_mask", torch.tril(torch.ones(c, c), -1))
        self.register_buffer("eye", torch.eye(c))
        self.lower = nn.Parameter(torch.tensor(lower, dtype=torch.float32))
        self.log_s = nn.Parameter(torch.tensor(log_s, dtype=torch.float32))
        self.upper = nn.Parameter(torch.tensor(upper, dtype=torch.float32))

    def lu_params(self) -> ic.LUParams:
        return ic.LUParams(self.p_idx, self.lower, self.upper, self.log_s, self.sign_s)

    def matrix(self, reverse: bool = False) -> torch.Tensor:
        lu = self.lu_params()
        return ic.lu_inverse(lu) if reverse else ic.lu_assemble(lu)

    def logdet(self) -> torch.Tensor:
        return ic.lu_logdet(self.lu_params())

    def forward(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        if self.impl == "pallas":
            y, ld = icf.invconv_lu_forward(x, self.lu_params())
        else:
            y, ld = ic.mix_channels(x, self.matrix()).to(x.dtype), self.logdet()
        if logdet is not None:
            logdet = logdet + x.shape[1] * x.shape[2] * ld
        return y, logdet

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        if self.impl == "pallas":
            return icf.invconv_lu_reverse(z, self.lu_params())
        return ic.mix_channels(z, self.matrix(reverse=True)).to(z.dtype)


class InvConv1x1(nn.Module):
    """Plain invertible 1x1 conv: a free (C, C) weight from a random rotation;
    log|det| by slogdet, the inverse by `torch.linalg.inv`, per call."""

    def __init__(self, c: int, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(ic.random_rotation(c, generator))

    def matrix(self, reverse: bool = False) -> torch.Tensor:
        return ic.plain_inverse(self.weight) if reverse else self.weight.float()

    def logdet(self) -> torch.Tensor:
        return ic.plain_logdet(self.weight)

    def forward(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        y = ic.mix_channels(x, self.matrix()).to(x.dtype)
        if logdet is not None:
            logdet = logdet + x.shape[1] * x.shape[2] * self.logdet()
        return y, logdet

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        return ic.mix_channels(z, self.matrix(reverse=True)).to(z.dtype)


class Permute(nn.Module):
    """Fixed channel permutation, y[..., j] = x[..., indices[j]]: a random
    shuffle drawn from the generator, or the channel order reversed.  An
    exact gather (the JAX package's one-hot HIGHEST matmul is exact too);
    logdet 0."""

    def __init__(self, c: int, mode: str, generator: torch.Generator | None = None):
        super().__init__()
        if mode == "shuffle":
            idx = torch.randperm(c, generator=generator)
        elif mode == "reverse":
            idx = torch.arange(c - 1, -1, -1)
        else:
            raise ValueError(f"unknown fixed permutation: {mode}")
        self.register_buffer("indices", idx)
        self.register_buffer("indices_inverse", torch.argsort(idx))

    def matrix(self, reverse: bool = False) -> torch.Tensor:
        idx = self.indices_inverse if reverse else self.indices
        return F.one_hot(idx, idx.shape[0]).float()

    def logdet(self) -> torch.Tensor:
        return torch.zeros((), device=self.indices.device)

    def forward(self, x: torch.Tensor, logdet: torch.Tensor | None = None):
        return x[..., self.indices], logdet

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        return z[..., self.indices_inverse]


def make_permutation(c: int, mode: str, lu_decomposed: bool, impl: str,
                     generator: torch.Generator | None) -> tuple[str, nn.Module]:
    """-> (the lineage's submodule name, the module): "invconv" for both 1x1
    convs, the mode ("shuffle" | "reverse") for a fixed permutation."""
    if mode == "invconv":
        if lu_decomposed:
            return "invconv", InvConv1x1LU(c, generator, impl)
        return "invconv", InvConv1x1(c, generator)
    return mode, Permute(c, mode, generator)


class FlowStep(nn.Module):
    """actnorm -> channel permutation -> affine/additive coupling.

    The permutation (`make_permutation`) sits under the lineage's name:
    `invconv` for the LU or plain 1x1 conv, `shuffle` or `reverse` for a
    fixed one; `permutation` reaches it.  A submodule named `reverse` would
    clash with the method `reverse` (`add_module` refuses an existing
    attribute), so it is registered in `_modules` directly and found there
    by `state_dict`, `load_state_dict` and `to`.

    The coupling net `f` is Conv(3x3) -> ReLU -> Conv(1x1) -> ReLU ->
    Conv2dZeros(3x3), run in `compute_dtype` (keys f.0 / f.2 / f.4)."""

    def __init__(self, c: int, hidden: int, coupling: str = "affine",
                 compute_dtype: torch.dtype = torch.float32,
                 actnorm_scale: float = 1.0,
                 generator: torch.Generator | None = None,
                 permutation: str = "invconv", lu_decomposed: bool = True,
                 invconv_impl: str = "xla"):
        super().__init__()
        if coupling not in ("affine", "additive"):
            raise ValueError(f"unknown coupling: {coupling}")
        ch = c // 2
        cout = c if coupling == "affine" else ch
        self.coupling = coupling
        self.compute_dtype = compute_dtype
        self.actnorm = ActNorm(c, actnorm_scale)
        self._perm_name, perm = make_permutation(c, permutation, lu_decomposed, invconv_impl,
                                                 generator)
        self._modules[self._perm_name] = perm
        self.f = coupling_net(ch, hidden, cout, generator)

    @property
    def permutation(self) -> nn.Module:
        return self._modules[self._perm_name]

    def _net(self, z1: torch.Tensor) -> torch.Tensor:
        return self.f(z1.to(self.compute_dtype))

    def forward(self, z: torch.Tensor, logdet: torch.Tensor):
        z, logdet = self.actnorm(z, logdet)
        z, logdet = self.permutation(z, logdet)
        z1, z2 = split_channel(z, "simple")
        h = self._net(z1)
        if self.coupling == "additive":
            z2 = z2 + h.to(z2.dtype)
        else:
            shift, raw = split_channel(h, "cross")
            z2 = (z2 + shift.to(z2.dtype)) * torch.sigmoid(raw + 2.0).to(z2.dtype)
            logdet = logdet + F.logsigmoid(raw + 2.0).sum(dim=(1, 2, 3))
        return cat_channel(z1, z2, "simple"), logdet

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        z1, z2 = split_channel(z, "simple")
        h = self._net(z1)
        if self.coupling == "additive":
            z2 = z2 - h.to(z2.dtype)
        else:
            shift, raw = split_channel(h, "cross")
            z2 = z2 / torch.sigmoid(raw + 2.0).to(z2.dtype) - shift.to(z2.dtype)
        z = cat_channel(z1, z2, "simple")
        return self.actnorm.reverse(self.permutation.reverse(z))


class Split2d(nn.Module):
    """Factor out half the channels against a learned conditional prior."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2dZeros(c // 2, c)

    def prior(self, z1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return split_channel(self.conv(z1.float()), "cross")

    def forward(self, z: torch.Tensor, logdet: torch.Tensor):
        """-> (z1, logdet + logp(z2), z2)."""
        z1, z2 = split_channel(z, "simple")
        mean, logs = self.prior(z1)
        return z1, logdet + gaussian_logp(mean, logs, z2.float()), z2

    def reverse(self, z1: torch.Tensor, generator: torch.Generator | None = None,
                temperature: float = 1.0, z2: torch.Tensor | None = None,
                eps: torch.Tensor | None = None) -> torch.Tensor:
        """z2 given, or drawn from the prior at `temperature`: its standard
        normal draw from `generator`, or `eps` (z1's shape)."""
        if z2 is None:
            mean, logs = self.prior(z1)
            z2 = gaussian_sample(mean, logs, temperature, generator, eps=eps).to(z1.dtype)
        return cat_channel(z1, z2, "simple")


class Squeeze(nn.Module):
    """Space-to-depth by 2 (paramless; counts in the lineage's layer index)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze2d(x, 2)

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        return unsqueeze2d(z, 2)
