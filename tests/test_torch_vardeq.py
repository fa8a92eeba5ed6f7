"""The port's variational dequantization (`models/vardeq.py`) against the
JAX package's `vardeq_apply`.

The port is handed the JAX package's own uniform draw: the test draws it as
`jax.random.uniform(key, shape, f32, 1e-5, 1 - 1e-5)` with the key it
passes to JAX, and feeds it to `VarDeq.forward_from_uniform` (or, through
the whole model, in place of `vardeq.draw_uniform`).  Weights go JAX ->
port through `state_dict_from_jax`, the vardeq subtree perturbed so the
q-flow is far from the identity."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.models import vardeq as jvardeq
from pytorch_glow_tpu.utils.torch_migrate import export_state_dict
from pytorch_glow_tpu_torch import DataConfig, GlowConfig, Profile, TrainConfig, build, init_glow
from pytorch_glow_tpu_torch import train as train_run
from pytorch_glow_tpu_torch.models import vardeq as tvardeq
from pytorch_glow_tpu_torch.ops.reshape import squeeze2d, unsqueeze2d
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import SMALL, _cfgs, _nontrivial_params, _port, _x

VD = dict(SMALL, dequant="variational", vardeq_steps=3, vardeq_width=16, vardeq_context_width=8)


def _vd_params(jcfg, seed=0):
    params = _nontrivial_params(jcfg, seed)
    rng = np.random.default_rng(seed + 7)
    params["vardeq"] = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), jnp.float32),
        params["vardeq"])
    return params


def _u0(key, shape):
    return jax.random.uniform(key, shape, jnp.float32, 1e-5, 1.0 - 1e-5)


def test_neg_log_q_is_exactly_zero_at_init():
    """At init every coupling's zero conv gives 0 and the final affine is
    the identity: q is uniform, -log q is 0 bit for bit, and u returns the
    draw (to the rounding of sigmoid(logit(u0))), its squeezed channels
    reversed once per flip (before steps 1, 3, ...)."""
    _, tcfg = _cfgs(VD)
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_x((4, *tcfg.image_shape)))
    u0 = tvardeq.draw_uniform(x.shape, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        x_deq, neg_log_q = model.vardeq.forward_from_uniform(x, u0)
        out = model.log_prob(x, torch.Generator().manual_seed(2))
    assert bool((neg_log_q == 0).all()) and bool((out["neg_log_q"] == 0).all())
    flipped = unsqueeze2d(squeeze2d(u0, 2).flip(-1), 2)  # vardeq_steps=3: one flip
    np.testing.assert_allclose((x_deq - x).numpy() * tcfg.n_bins, flipped.numpy(), atol=1e-5)
    assert 1e-5 <= float(u0.min()) and float(u0.max()) <= 1 - 1e-5


def test_vardeq_matches_jax_on_its_draw():
    jcfg, tcfg = _cfgs(VD)
    params = _vd_params(jcfg)
    model = _port(params, tcfg)
    x = _x((4, *jcfg.image_shape), 5)
    key = jax.random.key(11)
    x_deq_j, nlq_j = jax.jit(lambda p, k, x: jvardeq.vardeq_apply(p, k, x, jcfg))(
        params["vardeq"], key, jnp.asarray(x))
    u0 = torch.from_numpy(np.array(_u0(key, x.shape)))
    with torch.no_grad():
        x_deq, nlq = model.vardeq.forward_from_uniform(torch.from_numpy(x), u0)
    assert float(np.abs(np.asarray(nlq_j)).min()) > 0.1  # far from uniform
    np.testing.assert_allclose(x_deq.numpy(), np.asarray(x_deq_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nlq.numpy(), np.asarray(nlq_j), atol=1e-5, rtol=0)


def _jax_draw(monkeypatch, keys):
    """Make the port's draws the JAX package's, one key per call."""
    it = iter(keys)
    monkeypatch.setattr(tvardeq, "draw_uniform",
                        lambda shape, generator, device: torch.from_numpy(
                            np.array(_u0(next(it), tuple(shape)))))


def test_log_prob_and_grads_match_jax(monkeypatch):
    """The whole model's objective, nll and -log q on one draw within
    2e-4, the metric `vardeq_logq_bits`, and the grads of the loss on every
    vardeq parameter against jax.grad within 1e-4 of each tensor's largest
    magnitude."""
    jcfg, tcfg = _cfgs(VD)
    params = _vd_params(jcfg, seed=1)
    model = _port(params, tcfg)
    x = _x((4, *jcfg.image_shape), 6)
    key = jax.random.key(12)
    out_j = jax.jit(lambda p, x, k: jglow.log_prob(p, x, jcfg, rng=k))(
        params, jnp.asarray(x), key)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda vd: jglow.loss_fn({**params, "vardeq": vd}, jnp.asarray(x), jcfg, rng=key),
        has_aux=True))(params["vardeq"])
    _jax_draw(monkeypatch, [key, key])
    with torch.no_grad():
        out_t = model.log_prob(torch.from_numpy(x), torch.Generator())
    for k in ("objective", "nll", "neg_log_q"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    loss, mt = model.loss_fn(torch.from_numpy(x), torch.Generator())
    np.testing.assert_allclose(float(mt["vardeq_logq_bits"].detach()),
                               float(mj["vardeq_logq_bits"]),
                               rtol=2e-4, atol=2e-6)
    names = [n for n, _ in model.named_parameters() if n.startswith("vardeq.")]
    tensors = dict(model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, [tensors[n] for n in names])))
    want = state_dict_from_jax(jax.tree.map(np.asarray, {**params, "vardeq": gj}), tcfg)
    assert len(names) == 2 + 6 + 9 * tcfg.vardeq_steps
    for n in names:
        w = want[n].numpy()
        np.testing.assert_allclose(grads[n].numpy(), w, atol=1e-4 * float(np.abs(w).max()),
                                   rtol=0, err_msg=n)


def test_ddi_leaves_vardeq_untouched():
    jcfg, tcfg = _cfgs(VD)
    params = _vd_params(jcfg, seed=2)
    model = _port(params, tcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.ddi_init(torch.from_numpy(_x((8, *jcfg.image_shape), 4)))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in after if k.startswith("vardeq."))
    key = "flow.layers.1.actnorm.bias"
    assert not torch.equal(before[key], after[key])
    assert model.vardeq.ctx.conv1.actnorm.ddi is False


def test_state_dict_carries_vardeq():
    """The JAX export skips the vardeq subtree (the lineage has none); the
    bridge adds it under the port's names, and the port loads it strictly."""
    jcfg, tcfg = _cfgs(VD)
    params = _vd_params(jcfg, seed=3)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = export_state_dict(params, jcfg)
    extra = sorted(set(sd) - set(ref))
    assert set(ref) <= set(sd) and extra == sorted(init_glow(tcfg, device="cpu").vardeq
                                                  .state_dict(prefix="vardeq."))
    vd = params["vardeq"]
    np.testing.assert_array_equal(sd["vardeq.logs"].numpy(), np.asarray(vd["final"]["logs"]))
    np.testing.assert_array_equal(sd["vardeq.steps.2.4.weight"].numpy(),
                                  np.transpose(np.asarray(vd["steps"][2]["conv3"]["w"]),
                                               (3, 2, 0, 1)))
    init_glow(tcfg, device="cpu").load_state_dict(sd)  # strict


def test_trainer_logs_vardeq_logq_bits(tmp_path):
    glow = GlowConfig(**dict(VD, compute_dtype="bfloat16", flowstep_impl="pallas"))
    p = Profile(name="vd", glow=glow,
                train=TrainConfig(batch_size=4, scalar_log_gap=1, step_timeout_s=0),
                data=DataConfig(name="synthetic_textured"), out_dir=str(tmp_path))
    built = build(p, device="cpu")
    assert all(bool((v == 0).all()) for k, v in built.state["model"].state_dict().items()
               if k.startswith("vardeq.") and ".4." in k)
    result = train_run(built, num_steps=2, quiet=True)
    with open(tmp_path / "vd" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["vardeq_logq_bits"] for r in rows][0] in ("0.0", "-0.0")  # uniform at init
    assert np.isfinite(result["vardeq_logq_bits"]) and result["vardeq_logq_bits"] != 0


@pytest.mark.parametrize("steps", [1, 4])
def test_flips_alternate_like_jax(monkeypatch, steps):
    """One coupling and four (flips before steps 1 and 3): x_deq and -log q
    against JAX at each depth."""
    jcfg, tcfg = _cfgs(dict(VD, vardeq_steps=steps))
    params = _vd_params(jcfg, seed=4)
    model = _port(params, tcfg)
    x = _x((2, *jcfg.image_shape), 7)
    key = jax.random.key(13)
    x_deq_j, nlq_j = jvardeq.vardeq_apply(params["vardeq"], key, jnp.asarray(x), jcfg)
    _jax_draw(monkeypatch, [key])
    with torch.no_grad():
        x_deq, nlq = model.vardeq(torch.from_numpy(x), torch.Generator())
    np.testing.assert_allclose(x_deq.numpy(), np.asarray(x_deq_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nlq.numpy(), np.asarray(nlq_j), atol=1e-5, rtol=0)
