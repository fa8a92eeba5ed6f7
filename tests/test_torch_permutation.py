"""Every channel permutation of the port (LU and plain 1x1 conv, fixed
shuffle / reverse) against the JAX package's, as a layer and inside a tiny
model on each flow-step path and 1x1 conv implementation.

Weights go JAX -> port through `state_dict_from_jax`; inputs are numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.models import layers as JL
from pytorch_glow_tpu.utils.torch_migrate import export_state_dict
from pytorch_glow_tpu_torch import init_glow
from pytorch_glow_tpu_torch.models import layers as TL
from pytorch_glow_tpu_torch.utils.convert import _permutation, state_dict_from_jax
from test_torch_model import PALLAS, SMALL, _cfgs, _nontrivial_params, _port

# (flow_permutation, lu_decomposed) of each kind.
KINDS = {"lu": ("invconv", True), "plain": ("invconv", False),
         "shuffle": ("shuffle", True), "reverse": ("reverse", True)}


def _kind_kw(kind: str) -> dict:
    mode, lu = KINDS[kind]
    return dict(flow_permutation=mode, lu_decomposed=lu)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _layer_pair(kind: str, c: int, impl: str = "xla", seed: int = 0):
    mode, lu = KINDS[kind]
    params = JL.permutation_init(jax.random.key(seed), c, mode, lu)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), jnp.float32)
        if a.dtype == jnp.float32 and a.ndim == 2 else a, params)
    name, module = TL.make_permutation(c, mode, lu, impl, torch.Generator().manual_seed(seed))
    sd = {}
    _permutation("s", jax.tree.map(np.asarray, params), sd, mode)
    module.load_state_dict({k.removeprefix(f"s.{name}."): torch.from_numpy(np.array(v))
                            for k, v in sd.items()})
    return params, module, JL.permutation_kind(mode, lu)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_permutation_layer_matches_jax(kind):
    c = 12
    params, module, jkind = _layer_pair(kind, c)
    x = _x((2, 3, 3, c), 1)
    y, ld = module(torch.from_numpy(x), torch.zeros(2))
    jy, jld = JL.permutation_forward(params, jnp.asarray(x), jnp.zeros(2), jkind)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), atol=1e-4, rtol=1e-6)
    z = module.reverse(y)
    jz = JL.permutation_reverse(params, jy, jkind)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-5, rtol=0)
    np.testing.assert_allclose(z.detach().numpy(), x, atol=2e-5)
    if kind in ("shuffle", "reverse"):  # an exact gather
        assert torch.equal(z, torch.from_numpy(x))
    # The fused path's view of the layer: y = x @ matrix^T, and its logdet.
    np.testing.assert_allclose((torch.from_numpy(x) @ module.matrix().T).detach().numpy(),
                               y.detach().numpy(), atol=1e-5)
    ld_t = 9 * 2 * float(module.logdet().detach())
    np.testing.assert_allclose(ld_t, float(ld.detach().sum()), rtol=1e-5, atol=1e-6)


# flowstep_impl x invconv_impl; the 1x1 conv implementation only matters
# for the LU kind, so the others run once per flow-step path.
MODEL_CASES = [(kind, fimpl, iimpl) for kind in sorted(KINDS) for fimpl in ("xla", "pallas")
               for iimpl in (("xla", "pallas") if kind == "lu" else ("xla",))]


@pytest.mark.parametrize("kind,flowstep_impl,invconv_impl", MODEL_CASES)
def test_model_log_prob_and_reconstruct_match_jax(kind, flowstep_impl, invconv_impl):
    """log_prob and reconstruct of a tiny model against JAX on the same
    perturbed parameters: the unfused f32 path at the bound of
    test_torch_model.py's f32 test, the fused bf16 path (JAX kernels in
    interpret mode) at its rtol 2e-4."""
    base = SMALL if flowstep_impl == "xla" else PALLAS
    jcfg, tcfg = _cfgs(dict(base, **_kind_kw(kind), invconv_impl=invconv_impl))
    params = _nontrivial_params(jcfg, seed=2)
    model = _port(params, tcfg)
    x = np.random.default_rng(9).uniform(size=(4, *jcfg.image_shape)).astype(np.float32)
    nll_j = np.asarray(jglow.log_prob(params, jnp.asarray(x), jcfg)["nll"])
    rec_j = np.asarray(jglow.reconstruct(params, jnp.asarray(x), jcfg))
    with torch.no_grad():
        nll_t = model.log_prob(torch.from_numpy(x))["nll"].numpy()
        rec_t = model.reconstruct(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(nll_t, nll_j, rtol=2e-4, atol=2e-4 if flowstep_impl == "xla" else 0)
    np.testing.assert_allclose(rec_t, rec_j, atol=2e-4)
    np.testing.assert_allclose(rec_t, x, atol=2e-4)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_dict_from_jax_matches_export(kind):
    jcfg, tcfg = _cfgs(dict(SMALL, **_kind_kw(kind)))
    params = _nontrivial_params(jcfg, seed=4)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = export_state_dict(params, jcfg)
    assert sorted(sd) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    model = init_glow(tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_reverse_submodule_state_dict_round_trip():
    """A fixed "reverse" permutation lives under the submodule name
    `reverse`, beside the method `FlowStep.reverse`."""
    _, tcfg = _cfgs(dict(SMALL, flow_permutation="reverse"))
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = model.flow.layers[1]
    assert isinstance(step.permutation, TL.Permute) and callable(step.reverse)
    sd = model.state_dict()
    assert "flow.layers.1.reverse.indices" in sd and "flow.layers.1.reverse.indices_inverse" in sd
    assert torch.equal(sd["flow.layers.1.reverse.indices"], torch.arange(11, -1, -1))
    fresh = init_glow(tcfg, torch.Generator().manual_seed(2), "cpu")
    fresh.load_state_dict(sd)
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in sd.items())
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fresh.log_prob(x)["nll"], model.log_prob(x)["nll"])
