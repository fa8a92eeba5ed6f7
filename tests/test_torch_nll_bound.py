"""The port's discrete-NLL bound (`Glow.nll_bound`, `Inferer.nll_bound`)
against the JAX package's.

The two RNGs differ, so the bound is held on the port's own draws replayed:
a clone of the generator gives the same uniform noise, and JAX's
`log_prob(rng=None)` scores each dequantized batch.  Under variational
dequantization the port is handed the JAX package's own draws, one key of
`jax.random.split(rng, k)` per sample, as its `nll_bound` takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu_torch import GlowConfig, Inferer, init_glow
from pytorch_glow_tpu_torch.models import vardeq as tvardeq
from test_torch_model import SMALL, _cfgs, _nontrivial_params, _port, _x
from test_torch_vardeq import VD, _u0, _vd_params

COND = dict(SMALL, y_condition=True, y_classes=5, y_multi_class=False)


def _clone(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


@pytest.mark.parametrize("kw", [SMALL, VD], ids=["uniform", "variational"])
def test_elbo_with_one_sample_is_log_prob(kw):
    """k=1 elbo is the nll of `log_prob` with the same generator state, bit
    for bit."""
    jcfg, tcfg = _cfgs(kw)
    params = _vd_params(jcfg) if "vardeq_steps" in kw else _nontrivial_params(jcfg)
    model = _port(params, tcfg)
    x = torch.from_numpy(_x((4, *tcfg.image_shape)))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        want = model.log_prob(x, _clone(gen))["nll"]
        got = model.nll_bound(x, gen, samples=1, bound="elbo")
    assert torch.equal(got, want)


def test_iwae_is_at_most_elbo():
    """On the same four draws, the importance bound is tighter per image."""
    _, tcfg = _cfgs(SMALL)
    model = _port(_nontrivial_params(_cfgs(SMALL)[0], seed=1), tcfg)
    x = torch.from_numpy(_x((4, *tcfg.image_shape), 2))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        elbo = model.nll_bound(x, _clone(gen), samples=4, bound="elbo")
        iwae = model.nll_bound(x, gen, samples=4, bound="iwae")
    assert bool((iwae <= elbo).all()) and not torch.equal(iwae, elbo)


@pytest.mark.parametrize("bound", ["elbo", "iwae"])
def test_bound_matches_jax_on_replayed_draws(bound):
    """The port's bound against JAX `log_prob(rng=None)` on the same noise,
    replayed from a cloned generator, reduced the same way (logsumexp -
    log k, or the mean) and in bits/dim: within 2e-4.  On a y-conditional
    model with its labels."""
    jcfg, tcfg = _cfgs(COND)
    params = _nontrivial_params(jcfg, seed=2)
    rng = np.random.default_rng(8)
    for key in ("project_ycond", "project_class"):
        params["top"][key] = {f: jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32)
                              for f, v in params["top"][key].items()}
    model = _port(params, tcfg)
    x = _x((4, *tcfg.image_shape), 3)
    y = np.eye(5, dtype=np.float32)[[0, 3, 4, 1]]
    k = 3
    gen = torch.Generator().manual_seed(7)
    replay = _clone(gen)
    draws = [torch.rand(x.shape, generator=replay).numpy() for _ in range(k)]
    score = jax.jit(lambda xd: jglow.log_prob(params, xd, jcfg, y_onehot=jnp.asarray(y))[
        "objective"])
    objs = np.stack([np.asarray(score(jnp.asarray(x + d / tcfg.n_bins))) for d in draws])
    obj = logsumexp(objs, axis=0) - np.log(k) if bound == "iwae" else objs.mean(0)
    want = -obj / (np.log(2.0) * np.prod(tcfg.image_shape))
    with torch.no_grad():
        got = model.nll_bound(torch.from_numpy(x), gen, k, bound, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_variational_bound_matches_jax_nll_bound(monkeypatch):
    jcfg, tcfg = _cfgs(VD)
    params = _vd_params(jcfg, seed=4)
    model = _port(params, tcfg)
    x = _x((2, *tcfg.image_shape), 4)
    rng, k = jax.random.key(21), 3
    want = np.asarray(jax.jit(lambda p, x: jglow.nll_bound(p, x, jcfg, rng, k, "iwae"))(
        params, jnp.asarray(x)))
    keys = iter(jax.random.split(rng, k))
    monkeypatch.setattr(tvardeq, "draw_uniform", lambda shape, generator, device: (
        torch.from_numpy(np.array(_u0(next(keys), tuple(shape))))))
    with torch.no_grad():
        got = model.nll_bound(torch.from_numpy(x), torch.Generator(), k, "iwae")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dequant", ["gaussian", "none"])
def test_bound_refuses_gaussian_and_no_dequantization(dequant):
    model = init_glow(GlowConfig(**dict(SMALL, dequant=dequant)), device="cpu")
    with pytest.raises(ValueError, match="only a valid discrete-NLL bound"):
        model.nll_bound(torch.rand(2, 8, 8, 3), torch.Generator(), 2)
    with pytest.raises(ValueError, match="unknown bound"):
        init_glow(GlowConfig(**SMALL), device="cpu").nll_bound(
            torch.rand(2, 8, 8, 3), torch.Generator(), 2, "kl")


def test_inferer_nll_bound_on_uint8_images():
    """The Inferer preprocesses uint8 images and runs the bound without
    grad; without a generator it draws from one seeded 0."""
    _, tcfg = _cfgs(COND)
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3),
                                                                dtype=np.uint8))
    y = torch.eye(5)[[1, 2, 3, 4]]
    inf = Inferer(model)
    got = inf.nll_bound(images, 2, "iwae", y_onehot=y)
    want = model.nll_bound(model.preprocess(images), torch.Generator().manual_seed(0), 2, "iwae",
                           y)
    assert not got.requires_grad and torch.equal(got, want.detach())
    assert bool((inf.nll_bound(images, 2, "elbo", y_onehot=y) >= got).all())
