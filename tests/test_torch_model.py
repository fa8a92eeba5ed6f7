"""The port's Glow model against the JAX package's on identical weights.

Weights go JAX -> port through `state_dict_from_jax`; inputs, latents and
noise are numpy.  Parameters follow the `_nontrivial_params` pattern of
tests/test_parity_torch.py (DDI, then every zero-init conv perturbed) so no
flow is the identity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.utils.torch_migrate import export_state_dict
from pytorch_glow_tpu_torch import GlowConfig, Inferer, init_glow
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax

SMALL = dict(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2)
CONFIGS = {
    "affine": dict(SMALL),
    "additive": dict(SMALL, flow_coupling="additive"),
}
PALLAS = dict(image_shape=(8, 8, 3), hidden_channels=32, K=2, L=2,
              compute_dtype="bfloat16", flowstep_impl="pallas")


def _cfgs(kw):
    return JaxGlowConfig(**kw), GlowConfig(**kw)


def _nontrivial_params(cfg, seed=0):
    params = jglow.init_glow(jax.random.key(seed), cfg)
    x = jax.random.uniform(jax.random.key(seed + 1), (8, *cfg.image_shape))
    params = jglow.ddi_init(params, x, cfg)
    rng = np.random.default_rng(seed + 2)

    def perturb(leaf):
        return leaf + jnp.asarray(0.05 * rng.standard_normal(leaf.shape), jnp.float32)

    for level in params["levels"]:
        level["steps"]["coupling"]["conv3"] = jax.tree.map(perturb, level["steps"]["coupling"]["conv3"])
        if level["split"] is not None:
            level["split"]["prior_conv"] = jax.tree.map(perturb, level["split"]["prior_conv"])
    if "learn_top" in params["top"]:
        params["top"]["learn_top"] = jax.tree.map(perturb, params["top"]["learn_top"])
    return params


def _port(params, tcfg):
    model = init_glow(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return model.eval()


def _x(shape, seed=9):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_matches_export(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = export_state_dict(params, jcfg)
    assert sorted(sd) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    model = init_glow(tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()
    }
    # LUParams given as plain dicts convert the same.
    as_dicts = jax.tree.map(np.asarray, params)
    for level in as_dicts["levels"]:
        level["steps"]["perm"]["lu"] = level["steps"]["perm"]["lu"]._asdict()
    for key, val in state_dict_from_jax(as_dicts, tcfg).items():
        assert torch.equal(val, sd[key]), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_prob_matches_jax_f32(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg)
    model = _port(params, tcfg)
    x = _x((4, *jcfg.image_shape))
    out_j = jglow.log_prob(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out_t = model.log_prob(torch.from_numpy(x))
    np.testing.assert_allclose(out_t["z"].numpy(), np.asarray(out_j["z"]), atol=2e-4)
    np.testing.assert_allclose(out_t["nll"].numpy(), np.asarray(out_j["nll"]), rtol=2e-4, atol=2e-4)


def test_log_prob_matches_jax_pallas_interpret():
    """Fused path on both sides: the port's plain kernel version against the
    JAX kernel in interpret mode, both bf16 coupling.  Measured max relative
    difference 1.1e-7 at this size; bound 2e-4, the f32 path's, because a
    bf16 rounding of h1/h2 can flip where the f32 sums before it run in
    another order."""
    jcfg, tcfg = _cfgs(PALLAS)
    params = _nontrivial_params(jcfg)
    model = _port(params, tcfg)
    x = _x((4, *jcfg.image_shape))
    nll_j = np.asarray(jglow.log_prob(params, jnp.asarray(x), jcfg)["nll"])
    with torch.no_grad():
        nll_t = model.log_prob(torch.from_numpy(x))["nll"].numpy()
    np.testing.assert_allclose(nll_t, nll_j, rtol=2e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_with_z_splits_exact(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg, seed=5)
    model = _port(params, tcfg)
    x = _x((2, *jcfg.image_shape), 11)
    zj, _, splits_j, _ = jglow.encode(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        xt = model.decode(torch.from_numpy(np.array(zj)),
                          z_splits=[torch.from_numpy(np.array(s)) for s in splits_j])
        rec = model.reconstruct(torch.from_numpy(x))
    np.testing.assert_allclose(xt.numpy(), x, atol=2e-4)
    np.testing.assert_allclose(rec.numpy(), x, atol=2e-4)


def test_t0_decode_matches_jax():
    jcfg, tcfg = _cfgs(CONFIGS["affine"])
    params = _nontrivial_params(jcfg, seed=7)
    model = _port(params, tcfg)
    hf, wf, cf = jcfg.final_latent_shape
    z = 0.7 * np.random.default_rng(13).standard_normal((2, hf, wf, cf)).astype(np.float32)
    xj = jglow.decode(params, jnp.asarray(z), jcfg, rng=jax.random.key(0), temperature=0.0)
    with torch.no_grad():
        xt = model.decode(torch.from_numpy(z), temperature=0.0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=3e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ddi_matches_jax(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = jglow.init_glow(jax.random.key(3), jcfg)
    model = _port(params, tcfg)
    x = _x((8, *jcfg.image_shape), 4)
    ref = export_state_dict(jglow.ddi_init(params, jnp.asarray(x), jcfg), jcfg)
    model.ddi_init(torch.from_numpy(x))
    ours = model.state_dict()
    assert any("actnorm" in k for k in ref)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), val, atol=1e-5, rtol=0, err_msg=key)


def test_fused_reconstruct_exact_and_sample_on_cpu():
    """As the JAX package's own fused test: init + DDI, both directions on
    the fused path (its plain version here)."""
    _, tcfg = _cfgs(PALLAS)
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_x((4, *tcfg.image_shape), 1))
    model.ddi_init(x)
    with torch.no_grad():
        rec = model.reconstruct(x)
        imgs = model.sample(3, 0.7, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=2e-4)
    assert imgs.shape == (3, 8, 8, 3) and torch.isfinite(imgs).all()


def test_fused_matches_unfused_bf16():
    """Fused (kernel math) against unfused bf16 layers, the repo's rtol 2e-2."""
    jcfg, tcfg = _cfgs(PALLAS)
    params = _nontrivial_params(jcfg)
    fused = _port(params, tcfg)
    unfused = _port(params, dataclasses.replace(tcfg, flowstep_impl="xla"))
    x = torch.from_numpy(_x((4, *tcfg.image_shape)))
    with torch.no_grad():
        np.testing.assert_allclose(fused.log_prob(x)["nll"].numpy(),
                                   unfused.log_prob(x)["nll"].numpy(), rtol=2e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_inferer_serves_on_cpu(impl):
    tcfg = GlowConfig(**dict(PALLAS, flowstep_impl=impl))
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8))
    model.ddi_init(model.dequantize(model.preprocess(images), torch.Generator().manual_seed(2)))
    inf = Inferer(model)
    nll = inf.nll(images)
    assert nll.shape == (4,) and torch.isfinite(nll).all()
    samples = inf.sample(2, 0.7, torch.Generator().manual_seed(3))
    assert samples.shape == (2, 8, 8, 3) and samples.dtype == torch.uint8
    rec = inf.reconstruct(images)
    assert rec.dtype == torch.uint8
    assert int((rec.int() - images.int()).abs().max()) <= 1
    z, splits = inf.encode_full(images)
    assert torch.equal(inf.decode_full(z, splits), rec)
    assert inf.decode(inf.encode(images)).shape == images.shape
