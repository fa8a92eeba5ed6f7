"""The port's unfused layers against `pytorch_glow_tpu/models/layers.py` at f32.

Same math, f32 on both sides, sums in another order: atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.models import layers as JL
from pytorch_glow_tpu_torch.models import layers as TL
from pytorch_glow_tpu_torch.utils.convert import _conv2d, _conv2d_zeros
from pytorch_glow_tpu_torch.utils.convert import _step as export_step

ATOL = 1e-5
CFG = GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _noisy(tree, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), jnp.float32)
        if a.dtype == jnp.float32 else a,
        tree,
    )


def _load(module, prefix_dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in prefix_dict.items()})
    return module


def test_actnorm_forward_reverse():
    c = 6
    p = _noisy(JL.actnorm_init(c))
    x = _x((2, 3, 3, c))
    an = _load(TL.ActNorm(c), {"bias": np.asarray(p["bias"]).reshape(1, c, 1, 1),
                               "logs": np.asarray(p["logs"]).reshape(1, c, 1, 1)})
    y, ld = an(torch.from_numpy(x), torch.zeros(2))
    jy, jld, _ = JL.actnorm_forward(p, jnp.asarray(x), jnp.zeros(2))
    _close(y, jy)
    _close(ld, jld)
    _close(an.reverse(y), JL.actnorm_reverse(p, jy))


def test_actnorm_ddi():
    c = 5
    x = 3.0 * _x((4, 3, 3, c)) + 1.5
    an = TL.ActNorm(c, scale=2.0)
    an.ddi = True
    y, _ = an(torch.from_numpy(x))
    jy, _, jp = JL.actnorm_forward(JL.actnorm_init(c), jnp.asarray(x), None, ddi=True, scale=2.0)
    _close(an.bias.view(-1), jp["bias"])
    _close(an.logs.view(-1), jp["logs"])
    _close(y, jy)


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv2d(kernel):
    p = _noisy(JL.conv2d_init(jax.random.key(0), 4, 7, (kernel, kernel)))
    x = _x((2, 5, 5, 4))
    conv = TL.Conv2d(4, 7, kernel)
    sd = {}
    _conv2d("m", _np_tree(p), sd)
    _load(conv, {k[2:]: v for k, v in sd.items()})
    jy, _ = JL.conv2d_forward(p, jnp.asarray(x))
    _close(conv(torch.from_numpy(x)), jy)


def test_conv2d_zeros():
    p = _noisy(JL.conv2d_zeros_init(4, 6))
    x = _x((2, 5, 5, 4))
    conv = TL.Conv2dZeros(4, 6)
    sd = {}
    _conv2d_zeros("m", _np_tree(p), sd)
    _load(conv, {k[2:]: v for k, v in sd.items()})
    _close(conv(torch.from_numpy(x)), JL.conv2d_zeros_forward(p, jnp.asarray(x)))


def _step_pair(c, cfg, seed=0):
    sp = _noisy(jglow._flow_step_init(jax.random.key(seed), c, cfg), seed + 1)
    sd = {}
    export_step("s", _np_tree(sp), sd)
    step = TL.FlowStep(c, cfg.hidden_channels, cfg.flow_coupling)
    _load(step, {k[2:]: v for k, v in sd.items()})
    return sp, step


def test_invconv_lu():
    c = 8
    sp, step = _step_pair(c, CFG)
    x = _x((2, 3, 3, c))
    y, ld = step.invconv(torch.from_numpy(x), torch.zeros(2))
    jy, jld = JL.permutation_forward(sp["perm"], jnp.asarray(x), jnp.zeros(2), "lu")
    _close(y, jy)
    _close(ld, jld)
    _close(step.invconv.reverse(y), JL.permutation_reverse(sp["perm"], jy, "lu"))


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_flow_step_forward_reverse(mode):
    cfg = dataclasses.replace(CFG, flow_coupling=mode)
    c = 12
    sp, step = _step_pair(c, cfg)
    x = _x((2, 4, 4, c), 3)
    z, ld = step(torch.from_numpy(x), torch.zeros(2))
    jz, jld, _ = jglow._step_forward(sp, jnp.asarray(x), jnp.zeros(2), cfg, False)
    _close(z, jz)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=1e-6, atol=1e-4)
    _close(step.reverse(z), jglow._step_reverse(sp, jz, cfg))
    _close(step.reverse(z), x, atol=2e-5)


def test_split2d():
    c = 8
    p = _noisy(JL.split2d_init(c))
    x = _x((2, 3, 3, c), 4)
    split = TL.Split2d(c)
    sd = {}
    _conv2d_zeros("conv", _np_tree(p["prior_conv"]), sd)
    _load(split, sd)
    z1, ld, z2 = split(torch.from_numpy(x), torch.zeros(2))
    jz1, jld, jz2 = JL.split2d_forward(p, jnp.asarray(x), jnp.zeros(2))
    _close(z1, jz1)
    _close(z2, jz2)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=1e-6, atol=1e-4)
    _close(split.reverse(z1, z2=z2), x)
    # T=0 draws the prior mean on both sides.
    _close(split.reverse(z1, temperature=0.0),
           JL.split2d_reverse(p, jz1, jax.random.key(0), temperature=0.0))


def test_squeeze_layer():
    x = torch.from_numpy(_x((2, 4, 6, 3)))
    sq = TL.Squeeze()
    assert sq(x).shape == (2, 2, 3, 12)
    assert torch.equal(sq.reverse(sq(x)), x)
