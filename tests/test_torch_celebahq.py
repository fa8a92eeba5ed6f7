"""The celebahq256 path of the port on the CPU, against the JAX package:
a reduced celebahq256 model (64x64x3, L=3, K=2, hidden 32, additive
coupling, 5-bit input, remat) whose level 0 runs on row bands, the 5-bit
pre- and postprocessing, and remat on the unfused path.

Weights go JAX -> port through `state_dict_from_jax`; inputs are numpy.
The JAX side runs its halo kernels in interpret mode (`MAX_TILE_COLS`
shrunk, tests/test_flowstep_pallas.py:126-133); the port's chooser knobs
are shrunk so its level 0 takes bands of 8 rows.  Bounds as
tests/test_torch_model.py and tests/test_torch_train.py: nll rtol 2e-4 at
bf16 coupling, loss rtol 2e-5 and each grad within 1e-4 of its largest
magnitude at f32 coupling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu.utils.torch_migrate import export_state_dict
from pytorch_glow_tpu.utils.tree import merge, partition
from pytorch_glow_tpu_torch import PRESETS, Inferer, init_glow
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import _cfgs, _nontrivial_params, _port
from test_torch_train import _assert_scaled_close, _grads_as_state_dict, _images

HQ = dict(image_shape=(64, 64, 3), hidden_channels=32, K=2, L=3, n_bits_x=5,
          flow_coupling="additive", compute_dtype="bfloat16", flowstep_impl="pallas",
          remat=True)
BATCH = 4


@pytest.fixture
def bands(monkeypatch):
    """As at the preset's own batch: level 0 (32x32x12) on bands of 8 rows,
    several per group, in every direction; level 1 on bands in the backward
    only; the rest on the whole chain.  And a count of the band versions'
    calls."""
    monkeypatch.setattr(tfs, "BAND_PIXELS", 256)
    monkeypatch.setattr(tfs, "STAGING_BUDGET_BYTES", 1_200_000)
    for direction in ("forward", "reverse", "backward"):
        assert tfs.tiling(direction, BATCH, 32, 32, 12, 32, False) == "band"
        assert tfs.bands_per_launch(direction, BATCH, 32, 32, 12, 32, False) < 4 * 4
    assert [tfs.tiling(d, BATCH, 16, 16, 24, 32, False) for d in ("forward", "reverse", "backward")] \
        == ["whole", "whole", "band"]
    assert tfs.tiling("backward", BATCH, 8, 8, 48, 32, False) == "whole"
    calls = {}
    for name in ("step_forward_band_ref", "step_reverse_band_ref", "step_backward_band_ref"):
        def counted(*args, _fn=getattr(tfs, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(tfs, name, counted)
    monkeypatch.setattr(fsp, "MAX_TILE_COLS", 512)
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()
    yield calls
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()


def _x(seed=9):
    """5-bit images with their dequantisation noise, in [0, 1)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 32, (BATCH, 64, 64, 3))
    return ((bins + rng.uniform(size=bins.shape)) / 32.0).astype(np.float32)


def test_reduced_config_is_celebahq256_cut_to_size():
    full = PRESETS["celebahq256"].glow
    _, tcfg = _cfgs(HQ)
    for field in ("n_bits_x", "flow_coupling", "compute_dtype", "flowstep_impl", "remat"):
        assert getattr(tcfg, field) == getattr(full, field), field
    assert full.latent_shapes()[:2] == [(128, 128, 12), (64, 64, 24)]


def test_log_prob_on_bands_matches_jax_halo(bands):
    jcfg, tcfg = _cfgs(HQ)
    params = _nontrivial_params(jcfg)
    model = _port(params, tcfg)
    x = _x()
    nll_j = np.asarray(jglow.log_prob(params, jnp.asarray(x), jcfg)["nll"])
    with torch.no_grad():
        nll_t = model.log_prob(torch.from_numpy(x))["nll"].numpy()
    assert bands == {"step_forward_band_ref": HQ["K"]}
    np.testing.assert_allclose(nll_t, nll_j, rtol=2e-4)


def test_loss_grads_on_bands_match_jax_halo(monkeypatch, bands):
    monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
    monkeypatch.setattr(tfs, "COUPLING_DTYPE", torch.float32)
    jcfg, tcfg = _cfgs(HQ)
    params = _nontrivial_params(jcfg)
    x = _x(4)
    trainable, frozen = partition(params)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda tr: jglow.loss_fn(merge(tr, frozen), jnp.asarray(x), jcfg), has_aux=True)(trainable)
    want = _grads_as_state_dict(grads_j, frozen, tcfg)

    model = _port(params, tcfg)
    loss, _ = model.loss_fn(torch.from_numpy(x))
    loss.backward()
    assert bands == {"step_forward_band_ref": HQ["K"], "step_backward_band_ref": 2 * HQ["K"]}
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_scaled_close(got.numpy(), want[name], 1e-4, name)


def test_inferer_on_bands_reconstructs_5bit_images(bands):
    """nll, a T=0.7 sample and reconstruct of 5-bit images after init + DDI,
    level 0 on bands in both directions: reconstruct exact to 2e-4, so the
    images come back within one 5-bit bin (8 in uint8: the floor of a value
    a rounding below a bin edge)."""
    _, tcfg = _cfgs(HQ)
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    images = torch.from_numpy(_images(BATCH, (64, 64, 3)))
    x = model.preprocess(images)
    model.ddi_init(model.dequantize(x, torch.Generator().manual_seed(2)))
    inf = Inferer(model)
    nll = inf.nll(images)
    assert nll.shape == (BATCH,) and torch.isfinite(nll).all()
    samples = inf.sample(2, 0.7, torch.Generator().manual_seed(3))
    assert samples.shape == (2, 64, 64, 3) and samples.dtype == torch.uint8
    with torch.no_grad():
        rec = model.reconstruct(x)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=2e-4)
    diff = inf.reconstruct(images).int() - model.postprocess(x).int()
    assert int(diff.abs().max()) <= 8
    assert bands["step_forward_band_ref"] >= 3 * HQ["K"]
    assert bands["step_reverse_band_ref"] >= 2 * HQ["K"]


def test_state_dict_from_jax_at_six_levels():
    """The preset's depth of levels (L=6, additive, 5-bit) at a small width:
    the converted state_dict equals the JAX package's export key for key,
    and the unfused log_prob matches JAX at f32 (atol 2e-4)."""
    jcfg, tcfg = _cfgs(dict(HQ, hidden_channels=8, K=1, L=6, flowstep_impl="xla",
                            compute_dtype="float32"))
    params = _nontrivial_params(jcfg)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = export_state_dict(params, jcfg)
    assert sorted(sd) == sorted(ref) and any(".f.4." in k for k in sd)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    model = _port(params, tcfg)
    x = _x()[:2]
    out_j = jglow.log_prob(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out_t = model.log_prob(torch.from_numpy(x))
    assert out_t["z"].shape == (2, 1, 1, 384)
    np.testing.assert_allclose(out_t["z"].numpy(), np.asarray(out_j["z"]), atol=2e-4)
    np.testing.assert_allclose(out_t["nll"].numpy(), np.asarray(out_j["nll"]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_bits", [5, 8])
def test_preprocess_postprocess_match_jax(n_bits):
    jcfg, tcfg = _cfgs(dict(HQ, n_bits_x=n_bits))
    model = init_glow(tcfg, device="cpu")
    images = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, axis=-1)
    x_j = np.asarray(jglow.preprocess(jnp.asarray(images), jcfg))
    x_t = model.preprocess(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(x_t, x_j)
    assert len(np.unique(x_t)) == 2**n_bits
    rng = np.random.default_rng(1)
    floats = np.concatenate([x_j.ravel(), rng.uniform(-0.1, 1.1, 500).astype(np.float32)])
    np.testing.assert_array_equal(model.postprocess(torch.from_numpy(floats)).numpy(),
                                  np.asarray(jglow.postprocess(jnp.asarray(floats), jcfg)))


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_remat_gives_the_grads_of_no_remat(mode):
    """The unfused path under activation checkpointing recomputes each step
    in the backward: the same loss and grads bit for bit on the CPU."""
    _, tcfg = _cfgs(dict(HQ, image_shape=(16, 16, 3), flowstep_impl="xla",
                         compute_dtype="float32", flow_coupling=mode))
    x = torch.from_numpy(_x()[:, :16, :16])
    grads = []
    for remat in (True, False):
        model = init_glow(dataclasses.replace(tcfg, remat=remat), torch.Generator().manual_seed(0),
                          "cpu")
        model.ddi_init(x)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".f.4." in name:
                    p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
        loss, _ = model.loss_fn(x)
        grads.append([loss.detach()] + list(torch.autograd.grad(loss, list(model.parameters()),
                                                                allow_unused=True)))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
