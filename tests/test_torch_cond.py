"""The port's y-conditional Glow against the JAX package's, and the unfused
bf16 zero conv's f32 output.

Weights go JAX -> port through `state_dict_from_jax`; inputs and labels are
numpy.  Parameters follow `tests/test_torch_model._nontrivial_params` (DDI,
every zero-init conv perturbed), with the class heads `project_ycond` and
`project_class` perturbed too, as `tests/test_parity_torch.py`'s
y-conditional test does, so the labels reach the prior and the logits."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.models import layers as jlayers
from pytorch_glow_tpu.utils.torch_migrate import export_state_dict
from pytorch_glow_tpu_torch import (
    DataConfig,
    GlowConfig,
    Profile,
    TrainConfig,
    build,
    init_glow,
    train,
)
from pytorch_glow_tpu_torch.cli import infer as infer_cli
from pytorch_glow_tpu_torch.models import layers as tlayers
from pytorch_glow_tpu_torch.models.layers import Conv2dZeros
from pytorch_glow_tpu_torch.scripts.perf_data import write_imagenet64
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train.builder import labels_to_onehot
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import SMALL, _cfgs, _nontrivial_params, _port, _x

CLASSES = 7
COND = {"ce": dict(SMALL, y_condition=True, y_classes=CLASSES, y_multi_class=False),
        "bce": dict(SMALL, y_condition=True, y_classes=CLASSES, y_multi_class=True)}
BF16 = dict(SMALL, compute_dtype="bfloat16")


def _cond_params(jcfg, seed=21):
    params = _nontrivial_params(jcfg, seed)
    rng = np.random.default_rng(seed + 5)
    for key in ("project_ycond", "project_class"):
        params["top"][key] = {f: jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32)
                              for f, v in params["top"][key].items()}
    return params


def _labels(name, n=4, seed=3):
    rng = np.random.default_rng(seed)
    if name == "bce":
        return (rng.random((n, CLASSES)) > 0.5).astype(np.float32)
    return np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]


def _jit_log_prob(jcfg):
    return jax.jit(lambda p, x, y=None: jglow.log_prob(p, x, jcfg, y_onehot=y))


# -- the repair: the unfused bf16 zero conv keeps the f32 sum ------------------


def test_unfused_bf16_coupling_net_matches_jitted_jax():
    """The port's unfused bf16 coupling net (level 0, step 0) against jitted
    JAX `coupling_net_forward` at bf16 on perturbed weights.  Jitted XLA
    folds the zero conv's f32 cast into the conv, so its output is the f32
    sum of the bf16 operands; the port's is too, to f32 rounding: within
    1e-6 of the output's largest magnitude.  Measured: bitwise equal at this
    size; the bf16-rounded output of the unrepaired zero conv was off by
    3.8e-3 (up to 2^-9 of the magnitude)."""
    jcfg, tcfg = _cfgs(BF16)
    params = _nontrivial_params(jcfg, seed=3)
    model = _port(params, tcfg)
    z1 = np.random.default_rng(4).standard_normal((4, 4, 4, 6)).astype(np.float32)
    for k in range(jcfg.K):
        cp = jax.tree.map(lambda a, k=k: a[k], params["levels"][0]["steps"]["coupling"])
        want = np.asarray(jax.jit(lambda p, x: jlayers.coupling_net_forward(
            p, x, compute_dtype=jnp.bfloat16)[0])(cp, jnp.asarray(z1)))
        with torch.no_grad():
            got = model.flow.layers[1 + k]._net(torch.from_numpy(z1))
        assert got.dtype == torch.float32
        scale = float(np.abs(want).max())
        assert scale > 0.1
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * scale, rtol=0)


def test_zero_conv_backward_is_the_bf16_conv_s():
    """The repaired zero conv's backward is the bf16 conv's, as JAX's
    autodiff of conv(bf16) -> astype(f32) runs it: its grads equal, bit for
    bit, those of the unrepaired bf16 conv followed by `.float()`."""
    gen = torch.Generator().manual_seed(0)
    layer = Conv2dZeros(16, 6)
    with torch.no_grad():
        layer.weight.copy_(0.05 * torch.randn(layer.weight.shape, generator=gen))
    x = torch.relu(torch.randn(2, 5, 7, 16, generator=gen)).bfloat16().requires_grad_()
    g = torch.randn(2, 5, 7, 6, generator=gen)
    y = layer(x)
    got = torch.autograd.grad(y, (x, layer.weight), g)
    old = tlayers._conv_nhwc(x, layer.weight).float() + layer.bias
    want = torch.autograd.grad(old * torch.exp(layer.logs.view(-1) * 3.0), (x, layer.weight), g)
    assert y.dtype == torch.float32 and got[0].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tap_sum_is_the_f32_conv(monkeypatch):
    """The card's forward (`_tap_sum`: one bf16 product to the 9 taps with
    an f32 result, then the taps added at their offsets) against the
    true-f32 conv on the same operands, with the product's f32 result
    computed on the CPU as `mm(out_dtype=float32)` gives it on the card."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 7, 16, generator=gen).bfloat16()
    w = (0.05 * torch.randn(6, 16, 3, 3, generator=gen)).bfloat16()
    mm = torch.mm
    monkeypatch.setattr(torch, "mm", lambda a, b, out_dtype=None: mm(a.float(), b.float()))
    got = tlayers._tap_sum(x, w)
    want = tlayers._conv_nhwc(x.float(), w.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_unfused_bf16_log_prob_matches_jitted_jax():
    jcfg, tcfg = _cfgs(BF16)
    params = _nontrivial_params(jcfg, seed=3)
    model = _port(params, tcfg)
    x = _x((4, *jcfg.image_shape))
    want = np.asarray(_jit_log_prob(jcfg)(params, jnp.asarray(x))["nll"])
    with torch.no_grad():
        got = model.log_prob(torch.from_numpy(x))["nll"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# -- y-conditioning -------------------------------------------------------------


def test_top_prior_nll_and_logits_match_jax():
    jcfg, tcfg = _cfgs(COND["ce"])
    params = _cond_params(jcfg)
    model = _port(params, tcfg)
    x, y = _x((4, *jcfg.image_shape), 30), _labels("ce")
    mean_j, logs_j = jglow.top_prior(params, jcfg, 4, jnp.asarray(y))
    out_j = _jit_log_prob(jcfg)(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        mean_t, logs_t = model.top_prior(4, torch.from_numpy(y))
        out_t = model.log_prob(torch.from_numpy(x), y_onehot=torch.from_numpy(y))
        other = model.log_prob(torch.from_numpy(x),
                               y_onehot=torch.from_numpy(_labels("ce", seed=9)))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logs_t.numpy(), np.asarray(logs_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out_t["nll"].numpy(), np.asarray(out_j["nll"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out_t["y_logits"].numpy(), np.asarray(out_j["y_logits"]),
                               atol=2e-4)
    assert not torch.equal(out_t["nll"], other["nll"])  # the labels reach the prior


@pytest.mark.parametrize("name", sorted(COND))
def test_loss_fn_matches_jax(name):
    """loss, nll and loss_class: softmax cross-entropy over one-hot labels,
    or BCE-with-logits per attribute under y_multi_class; no noise."""
    jcfg, tcfg = _cfgs(COND[name])
    params = _cond_params(jcfg, seed=22)
    model = _port(params, tcfg)
    x, y = _x((4, *jcfg.image_shape), 31), _labels(name)
    _, mj = jax.jit(lambda p, x, y: jglow.loss_fn(p, x, jcfg, y_onehot=y))(
        params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        _, mt = model.loss_fn(torch.from_numpy(x), y_onehot=torch.from_numpy(y))
    assert sorted(mt) == sorted(mj) == ["loss", "loss_class", "nll"]
    for key in mt:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    np.testing.assert_allclose(float(mt["loss"]),
                               float(mt["nll"]) + tcfg.weight_y * float(mt["loss_class"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(COND))
def test_class_head_grads_match_jax(name):
    """The grads of the loss on project_ycond and project_class against
    jax.grad, f32: within 1e-4 of each tensor's largest magnitude."""
    jcfg, tcfg = _cfgs(COND[name])
    params = _cond_params(jcfg, seed=23)
    model = _port(params, tcfg)
    x, y = _x((4, *jcfg.image_shape), 32), _labels(name, seed=4)
    gj = jax.grad(lambda top: jglow.loss_fn({**params, "top": top}, jnp.asarray(x), jcfg,
                                            y_onehot=jnp.asarray(y))[0])(params["top"])
    names = [f"{h}.{f}" for h in ("project_ycond", "project_class")
             for f in ("weight", "bias", "logs")]
    tensors = dict(model.named_parameters())
    loss, _ = model.loss_fn(torch.from_numpy(x), y_onehot=torch.from_numpy(y))
    gt = dict(zip(names, torch.autograd.grad(loss, [tensors[n] for n in names])))
    for n in names:
        head, field = n.split(".")
        want = np.asarray(gj[head][{"weight": "w", "bias": "b", "logs": "logs"}[field]])
        want = want.T if field == "weight" else want
        scale = float(np.abs(want).max())
        assert scale > 0, n
        np.testing.assert_allclose(gt[n].numpy(), want, atol=1e-4 * scale, rtol=0, err_msg=n)


def test_conditional_model_needs_labels():
    _, tcfg = _cfgs(COND["ce"])
    model = _port(_cond_params(_cfgs(COND["ce"])[0]), tcfg)
    with pytest.raises(ValueError, match="needs y_onehot"):
        model.log_prob(torch.from_numpy(_x((2, 8, 8, 3))))
    with pytest.raises(ValueError, match="needs y_onehot"):
        model.sample(2, 0.7, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", sorted(COND))
def test_state_dict_carries_the_class_heads(name):
    """The bridge writes the lineage's names, which the JAX package's export
    writes too, and the port loads them strictly."""
    jcfg, tcfg = _cfgs(COND[name])
    params = _cond_params(jcfg)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = export_state_dict(params, jcfg)
    assert sorted(sd) == sorted(ref) and "project_class.weight" in sd
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    assert sd["project_class.weight"].shape == (CLASSES, 24)  # (out, in): C_final = 24
    init_glow(tcfg, device="cpu").load_state_dict(sd)  # strict


def test_labels_to_onehot():
    prof = Profile(glow=GlowConfig(**COND["ce"]))
    label = {"image": np.zeros((3, 8, 8, 3), np.uint8), "label": np.array([0, 6, 7])}
    got = labels_to_onehot(label, prof).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.one_hot(jnp.array([0, 6, 7]), CLASSES)))
    attr = {"image": torch.zeros(2, 8, 8, 3), "attr": torch.tensor([[1, -1, 1], [-1, -1, 1]])}
    np.testing.assert_array_equal(labels_to_onehot(attr, prof).numpy(),
                                  [[1, 0, 1], [0, 0, 1]])
    none = labels_to_onehot({"image": np.zeros((2, 8, 8, 3), np.uint8)}, prof)
    assert none.shape == (2, CLASSES) and not none.any()
    assert labels_to_onehot(label, Profile(glow=GlowConfig(**SMALL))) is None


# -- training and the CLI on a y-conditional profile ----------------------------


def _cond_profile(tmp_path, root, **train_kw):
    glow = GlowConfig(**dict(COND["ce"], compute_dtype="bfloat16", flowstep_impl="pallas"))
    kw = dict(batch_size=4, scalar_log_gap=2, plot_gap=0, checkpoint_gap=0, ema_decay=0.99,
              num_sample_images=3, step_timeout_s=0)
    kw.update(train_kw)
    return Profile(name="cond", glow=glow, train=TrainConfig(**kw),
                   data=DataConfig(name="imagenet64", image_size=8, root=str(root)),
                   out_dir=str(tmp_path))


@pytest.fixture(scope="module")
def npz_root(tmp_path_factory):
    return write_imagenet64(str(tmp_path_factory.mktemp("imagenet")), 64, size=8,
                            classes=CLASSES)


def test_train_step_n_equals_sequential_steps_with_labels(tmp_path, npz_root):
    """Three steps in one `train_step_n` call over stacked images and
    labels, against three `train_step` calls: bit for bit."""
    p = _cond_profile(tmp_path, npz_root)
    a, b = build(p, device="cpu"), build(dataclasses.replace(p, name="cond2"), device="cpu")
    group = [next(a.data) for _ in range(3)]
    ys = [labels_to_onehot(batch, p) for batch in group]
    assert all(y.sum(1).eq(1).all() for y in ys)
    t = p.train
    one = tstep.make_train_step(p.glow, a.tx, t.ema_decay, a.schedule)
    three = tstep.make_train_step_n(p.glow, b.tx, 3, t.ema_decay, b.schedule)
    sa = a.state
    for batch, y in zip(group, ys):
        sa, ma = one(sa, batch["image"], y)
    sb, mb = three(b.state, torch.stack([batch["image"] for batch in group]), torch.stack(ys))
    assert "loss_class" in ma and all(torch.equal(ma[k], mb[k]) for k in ma)
    for (name, pa), pb in zip(sa["model"].named_parameters(), sb["model"].parameters()):
        assert torch.equal(pa, pb), name
    a.data.close()
    b.data.close()


def test_trainer_carries_labels_through_every_boundary(tmp_path, npz_root, monkeypatch):
    """A y-conditional run from ImageNet-npz files through every gap, with
    steps_per_call=2: the train steps, eval batches, plot and SWD samples
    all get labels (the last batch's first rows), and `loss_class` lands in
    metrics.csv with loss = nll + weight_y * loss_class."""
    p = _cond_profile(tmp_path, npz_root, steps_per_call=2, plot_gap=2, eval_gap=2,
                      eval_batches=2, swd_gap=4, swd_images=3)
    built = build(p, device="cpu")
    seen = []
    model_cls = type(built.state["model"])
    sample, log_prob = model_cls.sample, model_cls.log_prob
    monkeypatch.setattr(model_cls, "sample", lambda self, n, t=1.0, g=None, y=None: (
        seen.append(("sample", n, None if y is None else tuple(y.shape))),
        sample(self, n, t, g, y))[1])
    monkeypatch.setattr(model_cls, "log_prob", lambda self, x, g=None, y_onehot=None: (
        seen.append(("log_prob", None if y_onehot is None else tuple(y_onehot.shape))),
        log_prob(self, x, g, y_onehot))[1])
    result = train(built, num_steps=4, quiet=True)
    assert result["final_step"] == 4 and np.isfinite(result["loss_class"])
    assert ("sample", 3, (3, CLASSES)) in seen  # the plot's and the SWD's samples
    assert ("log_prob", None) not in seen and ("log_prob", (4, CLASSES)) in seen
    with open(tmp_path / "cond" / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss")]
    assert len(rows) == 2 and all(r["loss_class"] for r in rows)
    for r in rows:
        np.testing.assert_allclose(float(r["loss"]),
                                   float(r["nll"]) + 0.01 * float(r["loss_class"]), rtol=1e-6)
    evals = [r for r in csv.DictReader(open(tmp_path / "cond" / "metrics.csv"))
             if r.get("eval_nll")]
    assert [int(r["step"]) for r in evals] == [2, 4]
    assert (tmp_path / "cond" / "samples" / "step_00000004.png").is_file()


def _infer(out, root, *argv):
    tiny = ["--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=16",
            "--set", "glow.K=2", "--set", "glow.L=2", "--set", f"glow.y_classes={CLASSES}",
            "--set", "train.batch_size=4", "--set", "data.image_size=8"]
    return infer_cli.main([*argv, "imagenet64-cond", "--cpu", "--out-dir", str(out),
                           "--data-root", str(root), *tiny])


def test_cli_sample_class_id(tmp_path, npz_root, capsys):
    _infer(tmp_path, npz_root, "sample", "-n", "4", "--class-id", "5",
           "-o", str(tmp_path / "s.png"))
    assert "(4 samples @ T=0.7, class 5)" in capsys.readouterr().out
    assert Image.open(tmp_path / "s.png").size == (2 * 10 + 2, 2 * 10 + 2)
    with pytest.raises(SystemExit) as e:
        _infer(tmp_path, npz_root, "sample", "--class-id", str(CLASSES))
    assert str(e.value.code) == f"error: --class-id {CLASSES} out of range [0, {CLASSES})"
    with pytest.raises(SystemExit) as e:
        infer_cli.main(["sample", "cifar10", "--cpu", "--out-dir", str(tmp_path),
                        "--class-id", "1"])
    assert str(e.value.code) == "error: --class-id requires a y-conditional profile"
    with pytest.raises(SystemExit) as e:
        _infer(tmp_path, npz_root, "sample")
    assert "needs --class-id" in str(e.value.code)


def test_cli_nll_bound_with_labels(tmp_path, npz_root, capsys):
    """nll on a y-conditional profile scores each batch under its labels;
    --dequant-samples 2 --bound iwae prints the bound, above the bin-corner
    value's floor of 0 and finite."""
    _infer(tmp_path, npz_root, "nll", "--batches", "2", "--dequant-samples", "2",
           "--bound", "iwae")
    out = capsys.readouterr().out
    assert "over 8 images (iwae bound, 2 noise draws)" in out
    assert 0 < float(out.split("nll: ")[1].split()[0]) < 16
    _infer(tmp_path, npz_root, "nll", "--batches", "1")
    assert "over 4 images (noise-free (bin corner))" in capsys.readouterr().out
