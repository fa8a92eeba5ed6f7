"""The port's ops against the JAX package's on the same numpy inputs.

f32 throughout and the same operations, so the bound is atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.ops import invconv_xla as jic
from pytorch_glow_tpu.ops import math as jmath
from pytorch_glow_tpu.ops import reshape as jreshape
from pytorch_glow_tpu_torch.ops import invconv as tic
from pytorch_glow_tpu_torch.ops import math as tmath
from pytorch_glow_tpu_torch.ops import reshape as treshape

ATOL = 1e-6


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 8, 6, 5)])
def test_squeeze_unsqueeze(shape):
    x = _x(shape)
    sq = treshape.squeeze2d(torch.from_numpy(x))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jreshape.squeeze2d(jnp.asarray(x))))
    np.testing.assert_array_equal(treshape.unsqueeze2d(sq).numpy(), x)


@pytest.mark.parametrize("mode", ["simple", "cross"])
def test_split_cat(mode):
    x = _x((2, 3, 3, 8))
    ta, tb = treshape.split_channel(torch.from_numpy(x), mode)
    ja, jb = jreshape.split_channel(jnp.asarray(x), mode)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(treshape.cat_channel(ta, tb, mode).numpy(), x)


def test_gaussian_logp_and_bits():
    mean, logs, x = _x((3, 4, 4, 6), 1), 0.3 * _x((3, 4, 4, 6), 2), _x((3, 4, 4, 6), 3)
    tl = tmath.gaussian_logp(*(torch.from_numpy(a) for a in (mean, logs, x)))
    jl = jmath.gaussian_logp(*(jnp.asarray(a) for a in (mean, logs, x)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-4)
    dims = tmath.num_dims((3, 4, 4, 6))
    assert dims == jmath.num_dims((3, 4, 4, 6)) == 96
    _close(tmath.bits_per_dim(tl, dims), jmath.bits_per_dim(jl, dims), atol=1e-5)
    assert tmath.discretization_correction(dims, 256.0) == jmath.discretization_correction(dims, 256.0)


def test_gaussian_sample_temperature():
    mean, logs = torch.zeros(2, 1, 1, 4), torch.full((2, 1, 1, 4), -1.0)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tmath.gaussian_sample(mean, logs, 0.0, g), mean)
    s = tmath.gaussian_sample(mean, logs, 0.5, g, shape=(2, 3, 3, 4))
    assert s.shape == (2, 3, 3, 4) and torch.isfinite(s).all()


@pytest.mark.parametrize("c", [4, 12, 24])
def test_lu_assemble_inverse_logdet(c):
    lu_j = jic.lu_init(jax.random.key(c), c)
    rng = np.random.default_rng(c)
    lu_j = lu_j._replace(
        l_raw=lu_j.l_raw + jnp.asarray(0.1 * rng.standard_normal((c, c)), jnp.float32),
        u_raw=lu_j.u_raw + jnp.asarray(0.1 * rng.standard_normal((c, c)), jnp.float32),
    )
    lu_t = tic.LUParams(*(torch.from_numpy(np.array(a)) for a in lu_j))
    _close(tic.lu_assemble(lu_t), jic.lu_assemble(lu_j))
    _close(tic.lu_inverse(lu_t), jic.lu_inverse(lu_j))
    _close(tic.lu_logdet(lu_t), jic.lu_logdet(lu_j))
    x = _x((2, 3, 3, c), 7)
    w = jic.lu_assemble(lu_j)
    _close(tic.mix_channels(torch.from_numpy(x), torch.from_numpy(np.array(w))),
           jic.mix_channels(jnp.asarray(x), w))
