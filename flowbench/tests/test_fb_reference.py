"""The frozen reference against the port's CPU path at a tiny width, for
both couplings and both bit depths, with every parameter the benchmark
draws non-zero (Glow's zero-initialised convs included): bits/dim,
sampling from given noise, DDI, the training gradient and the optimizer
chain over three steps.  The port runs its unfused f32 layers, so the two
agree to f32 rounding."""


import pytest
import torch

from flowbench import weights
from flowbench.kinds.sample import noise_shapes
from flowbench.reference import glow as ref
from flowbench.reference.optim import Adam
from pytorch_glow_tpu_torch.config import GlowConfig, OptimConfig, TrainConfig
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.train.optim import make_optimizer

torch.set_num_threads(1)

CASES = [("affine", 8), ("additive", 5)]


def tiny(coupling: str, n_bits: int) -> dict:
    return {"image_shape": [8, 8, 3], "hidden_channels": 8, "K": 2, "L": 2,
            "flow_coupling": coupling, "n_bits_x": n_bits, "flow_permutation": "invconv",
            "learn_top": True, "actnorm_scale": 1.0}


def port(glow: dict, state: dict):
    cfg = GlowConfig(image_shape=tuple(glow["image_shape"]), hidden_channels=glow["hidden_channels"],
                     K=glow["K"], L=glow["L"], flow_coupling=glow["flow_coupling"],
                     n_bits_x=glow["n_bits_x"], compute_dtype="float32", flowstep_impl="xla")
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(state)
    return model


def batch(glow: dict, seed: int, n: int = 4) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *glow["image_shape"]), dtype=torch.uint8, generator=gen)


@pytest.mark.parametrize("coupling,n_bits", CASES)
def test_drawn_weights_are_all_nonzero(coupling, n_bits):
    state = weights.draw(tiny(coupling, n_bits), 3, "cpu")
    for name, t in state.items():
        if name.endswith(("l_mask", "eye", ".p")) or "invconv.lower" in name \
                or "invconv.upper" in name:
            continue  # fixed buffers; the triangles' other halves are unused
        assert bool((t != 0).all()), name


@pytest.mark.parametrize("coupling,n_bits", CASES)
def test_nll_and_sample_match_the_port(coupling, n_bits):
    glow = tiny(coupling, n_bits)
    state = weights.draw(glow, 4, "cpu")
    model = port(glow, state)
    x = ref.preprocess(batch(glow, 1), glow)
    with torch.no_grad():
        want = model.log_prob(x)["nll"]
    torch.testing.assert_close(ref.nll(x, state, glow), want, rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    noise = [torch.randn(s, generator=gen) for s in noise_shapes(glow, 3)]
    with torch.no_grad():
        want = model.sample(3, 0.7, noise=noise)
    torch.testing.assert_close(ref.sample(noise, 0.7, state, glow), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("coupling,n_bits", CASES)
def test_ddi_gradient_and_optimizer_match_the_port(coupling, n_bits):
    glow = tiny(coupling, n_bits)
    state = weights.draw(glow, 5, "cpu")
    P = {k: v.clone() for k, v in state.items()}
    model = port(glow, state)
    x0 = ref.preprocess(batch(glow, 6), glow) + torch.rand(4, 8, 8, 3) / 2 ** n_bits
    model.ddi_init(x0)
    ref.ddi(x0, P, glow)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(P[name], t, rtol=1e-5, atol=1e-5, msg=name)
        P[name] = t.detach().clone()  # the optimizers below start from one state

    optim = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8,
             "schedule": "noam", "warmup_steps": 10}
    train = {"max_grad_clip": 5.0, "max_grad_norm": 0.5}  # the norm clip acts
    tx = make_optimizer(OptimConfig(**dict(optim, betas=(0.9, 0.999))),
                        TrainConfig(max_grad_clip=5.0, max_grad_norm=0.5))
    named = [(n, p) for n, p in model.named_parameters()]
    names = [n for n, _ in named]
    opt_state = tx.init([p for _, p in named])
    adam = Adam(optim, train, names, P)
    for step in range(3):
        x = ref.preprocess(batch(glow, 10 + step), glow) + torch.rand(4, 8, 8, 3) / 2 ** n_bits
        loss = model.loss_fn(x)[0]
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(
            named, torch.autograd.grad(loss, [p for _, p in named], allow_unused=True))]
        ref_loss, ref_grads = ref.loss_and_grads(x, P, names, glow, rows=3)
        assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5, abs=1e-5)
        for n, g in zip(names, grads):
            torch.testing.assert_close(ref_grads[n], g, rtol=1e-3, atol=1e-5, msg=n)
        flat = tx.flatten([p for _, p in named], grads)
        updates, opt_state = tx.update(flat, opt_state)
        tx.apply([p for _, p in named], updates)
        adam.step(P, {n: g.clone() for n, g in zip(names, grads)})
        for n, p in named:
            torch.testing.assert_close(P[n], p.detach(), rtol=1e-5, atol=1e-7, msg=n)


def test_fp8_control_rounds_coarser_than_bf16():
    t = torch.randn(1000) * 0.01
    err8 = (ref.fp8(t) - t).abs().max()
    err16 = (t.to(torch.bfloat16).float() - t).abs().max()
    assert err8 > 4 * err16 > 0
