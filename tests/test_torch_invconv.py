"""The port's LU 1x1 conv (`ops/invconv_fused.py`) against the JAX package's
K6 kernels (`pytorch_glow_tpu/ops/invconv_pallas.py`, interpret mode on the
CPU), with the bounds of tests/test_invconv_pallas.py.

On a CPU tensor the port runs the plain version; the kernels themselves run
only on the card (the `cuda` test below, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.ops import invconv_pallas as icp
from pytorch_glow_tpu.ops import invconv_xla as jic
from pytorch_glow_tpu_torch.models.layers import InvConv1x1LU
from pytorch_glow_tpu_torch.ops import invconv as ic
from pytorch_glow_tpu_torch.ops import invconv_fused as icf

# (C, N): every narrow width and a wide one, at ragged row counts.
WIDTH_CASES = [(c, n) for c in (12, 24, 48, 96) for n in (1000, 1025)]


def _lu(c, seed=0):
    """JAX LU factors perturbed off the rotation (the JAX tests' `_lu`), with
    numpy noise; -> (JAX LUParams, the port's LUParams)."""
    p = jic.lu_init(jax.random.key(seed), c)
    rng = np.random.default_rng(seed + 1)
    p = p._replace(
        l_raw=p.l_raw + jnp.asarray(0.02 * rng.standard_normal((c, c)), jnp.float32),
        u_raw=p.u_raw + jnp.asarray(0.02 * rng.standard_normal((c, c)), jnp.float32),
        log_s=p.log_s + 0.1,
    )
    t = ic.LUParams(
        p_idx=torch.from_numpy(np.asarray(p.p_idx).astype(np.int64)),
        l_raw=torch.from_numpy(np.array(p.l_raw)),
        u_raw=torch.from_numpy(np.array(p.u_raw)),
        log_s=torch.from_numpy(np.array(p.log_s)),
        sign_s=torch.from_numpy(np.array(p.sign_s)),
    )
    return p, t


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("c,n", sorted({(12, 64), (48, 1024), *WIDTH_CASES}))
def test_forward_matches_jax_kernel(c, n):
    jlu, tlu = _lu(c)
    x = _x((n, c))
    y_j, ld_j = icp.invconv_lu_forward(jnp.asarray(x), jlu)
    y_t, ld_t = icf.invconv_lu_forward(torch.from_numpy(x), tlu)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-6)


def test_forward_nhwc_shape():
    jlu, tlu = _lu(24, seed=5)
    x = _x((2, 8, 8, 24), 6)
    y_t, _ = icf.invconv_lu_forward(torch.from_numpy(x), tlu)
    assert y_t.shape == x.shape
    y_j, _ = icp.invconv_lu_forward(jnp.asarray(x), jlu)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)


@pytest.mark.parametrize("c,rows", [(48, (4, 4, 4)), *((c, (n,)) for c, n in WIDTH_CASES)])
def test_reverse_roundtrip_and_matches_jax_kernel(c, rows):
    jlu, tlu = _lu(c, seed=7)
    x = _x((*rows, c), 8)
    y, _ = icf.invconv_lu_forward(torch.from_numpy(x), tlu)
    x_rec = icf.invconv_lu_reverse(y, tlu)
    np.testing.assert_allclose(x_rec.numpy(), x, atol=2e-4)
    x_j = icp.invconv_lu_reverse(jnp.asarray(y.numpy()), jlu)
    np.testing.assert_allclose(x_rec.numpy(), np.asarray(x_j), atol=2e-5)


def test_gradients_match_jax_kernel():
    """grads of sum(y^2) + 3 logdet in x, l_raw, u_raw and log_s, against
    `jax.grad` through the JAX kernel's custom VJP."""
    jlu, tlu = _lu(12, seed=9)
    x = _x((64, 12), 10)

    def loss_j(x, floats):
        y, ld = icp.invconv_lu_forward(
            x, jlu._replace(l_raw=floats[0], u_raw=floats[1], log_s=floats[2]))
        return jnp.sum(y**2) + 3.0 * ld

    gj_x, gj_f = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                  (jlu.l_raw, jlu.u_raw, jlu.log_s))
    xt = torch.from_numpy(x).requires_grad_()
    floats = [t.clone().requires_grad_() for t in (tlu.l_raw, tlu.u_raw, tlu.log_s)]
    y, ld = icf.invconv_lu_forward(xt, tlu._replace(l_raw=floats[0], u_raw=floats[1],
                                                    log_s=floats[2]))
    ((y**2).sum() + 3.0 * ld).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj_x), atol=1e-3)
    for t, j in zip(floats, gj_f):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-3)


def _plain_launch_forward(x2d, *factors):
    w = ic.lu_assemble(ic.LUParams(*factors))
    return ic.mix_channels(x2d, w), w


def _patch_launches(monkeypatch):
    """The kernels' launches swapped for their plain versions, as only the
    card can run them."""
    monkeypatch.setattr(icf, "_launch_forward", _plain_launch_forward)
    monkeypatch.setattr(icf, "_launch_mix", ic.mix_channels)


def _signed_lu(c, seed):
    """`_lu` with every other sign_s negative (a JAX LU of a rotation may
    have none), the port's and JAX's alike; checks the cases the closed-form
    backward must cover: a non-identity P, negative signs, and non-zero
    entries in the triangles the factors mask."""
    jlu, tlu = _lu(c, seed)
    sign = np.where(np.arange(c) % 2 == 1, -1.0, 1.0).astype(np.float32)
    jlu = jlu._replace(sign_s=jnp.asarray(sign))
    tlu = tlu._replace(sign_s=torch.from_numpy(sign))
    assert not torch.equal(tlu.p_idx, torch.arange(c))
    upper = torch.ones(c, c, dtype=torch.bool).triu()
    assert bool(tlu.l_raw[upper].all()) and bool(tlu.u_raw[upper.T].all())
    return jlu, tlu


def test_autograd_functions_match_plain_autograd(monkeypatch):
    """The Functions' backward (the plain f32 math the card runs after the
    kernels) against autograd of the plain version."""
    _patch_launches(monkeypatch)
    _, tlu = _lu(12, seed=11)
    x = torch.from_numpy(_x((50, 12), 12))
    g = torch.from_numpy(_x((50, 12), 13))

    def leaves():
        return [t.clone().requires_grad_() for t in (x, tlu.l_raw, tlu.u_raw, tlu.log_s)]

    got = leaves()
    y = icf._LUForward.apply(got[0], tlu.p_idx, got[1], got[2], got[3], tlu.sign_s)
    w_inv = ic.lu_inverse(tlu._replace(l_raw=got[1], u_raw=got[2], log_s=got[3]))
    z = icf._Mix.apply(y, w_inv)
    torch.autograd.backward([y, z], [g, g])
    want = leaves()
    lu = tlu._replace(l_raw=want[1], u_raw=want[2], log_s=want[3])
    y_ref = ic.mix_channels(want[0], ic.lu_assemble(lu))
    z_ref = ic.mix_channels(y_ref, ic.lu_inverse(lu))
    torch.autograd.backward([y_ref, z_ref], [g, g])
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(), atol=0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, tlu = _lu(12)
    x = torch.from_numpy(_x((2, 3, 3, 12)))
    icf.reset_launches()
    y, ld = icf.invconv_lu_forward(x, tlu)
    x_rec = icf.invconv_lu_reverse(y, tlu)
    assert icf.launches == {"invconv_forward": 0, "invconv_reverse": 0}
    assert not any(v for counts in icf.path_launches.values() for v in counts.values())
    assert torch.equal(y, ic.mix_channels(x, ic.lu_assemble(tlu)))
    assert torch.equal(ld, ic.lu_logdet(tlu))
    assert torch.equal(x_rec, ic.mix_channels(y, ic.lu_inverse(tlu)))


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _, tlu = _lu(12)
    x = torch.from_numpy(_x((4, 3, 12)))
    with pytest.raises(ValueError, match="float32"):
        icf.invconv_lu_forward(x.double(), tlu)
    with pytest.raises(ValueError, match="contiguous"):
        icf.invconv_lu_forward(x.transpose(0, 1), tlu)
    with pytest.raises(ValueError, match="expected"):
        icf.invconv_lu_reverse(x[..., :6].contiguous(), tlu)
    # The launches themselves take CUDA tensors only: no silent CPU path.
    with pytest.raises(ValueError, match="CUDA"):
        icf._launch_forward(x.view(-1, 12), *tlu)
    with pytest.raises(ValueError, match="CUDA"):
        icf._launch_mix(x.view(-1, 12), torch.eye(12))


@pytest.mark.parametrize("c", [12, 48])
def test_closed_form_backward_matches_jax_and_plain_autograd(monkeypatch, c):
    """`_LUForward.backward` (gx = g W and the factors' grads in closed form,
    `lu_grads`) against `jax.grad` through the JAX kernel's custom VJP
    (atol 1e-3, the bound of `test_gradients_match_jax_kernel`) and against
    autograd of `lu_assemble` (rtol/atol 1e-5), sign_s's grad included;
    the masked triangles' grads exactly 0."""
    _patch_launches(monkeypatch)
    jlu, tlu = _signed_lu(c, seed=21)
    x, g = _x((300, c), 22), _x((300, c), 23)

    def loss_j(x, floats):
        y, _ = icp.invconv_lu_forward(
            x, jlu._replace(l_raw=floats[0], u_raw=floats[1], log_s=floats[2]))
        return jnp.sum(y * g)

    gj_x, gj_f = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                  (jlu.l_raw, jlu.u_raw, jlu.log_s))

    def leaves():
        return [torch.from_numpy(x).requires_grad_(),
                *(t.clone().requires_grad_() for t in (tlu.l_raw, tlu.u_raw, tlu.log_s,
                                                        tlu.sign_s))]

    got = leaves()
    y = icf._LUForward.apply(got[0], tlu.p_idx, *got[1:])
    y.backward(torch.from_numpy(g))
    want = leaves()
    y_ref = ic.mix_channels(want[0], ic.lu_assemble(ic.LUParams(tlu.p_idx, *want[1:])))
    y_ref.backward(torch.from_numpy(g))
    for a, j in zip(got, (gj_x, *gj_f)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(j), atol=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.triu(got[1].grad).any() and not torch.tril(got[2].grad).any()
    assert got[1].grad.abs().sum() > 0 and got[2].grad.abs().sum() > 0


def test_layer_forward_and_backward_need_no_nested_autograd(monkeypatch):
    """A forward and reverse through `InvConv1x1LU(impl="pallas")` on the
    kernels' route, and the backward, with `torch.autograd.grad` patched to
    raise: the closed-form backward runs no second autograd pass."""
    _patch_launches(monkeypatch)
    monkeypatch.setattr(icf, "_kernels", lambda t: True)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.autograd.grad called")

    monkeypatch.setattr(torch.autograd, "grad", refuse)
    conv = InvConv1x1LU(12, torch.Generator().manual_seed(4), impl="pallas")
    x = torch.from_numpy(_x((2, 5, 5, 12), 24)).requires_grad_()
    icf.reset_launches()
    y, ld = conv(x, torch.zeros(2))
    z = conv.reverse(y)
    ((y**2).sum() + ld.sum() + (z**2).sum()).backward()
    assert icf.launches == {"invconv_forward": 1, "invconv_reverse": 1}
    for t in (x, conv.lower, conv.upper, conv.log_s):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert t.grad.abs().sum() > 0


def test_calls_without_grad_skip_the_autograd_functions(monkeypatch):
    """Under `torch.no_grad` (serving, DDI) the wrappers launch directly:
    the same results as the plain version, one counted call each, and no
    autograd Function."""
    _patch_launches(monkeypatch)
    monkeypatch.setattr(icf, "_kernels", lambda t: True)

    def refuse(*args):
        raise AssertionError("autograd Function applied under no_grad")

    monkeypatch.setattr(icf._LUForward, "apply", refuse)
    monkeypatch.setattr(icf._Mix, "apply", refuse)
    _, tlu = _lu(24, seed=26)
    x = torch.from_numpy(_x((2, 3, 3, 24), 27))
    icf.reset_launches()
    with torch.no_grad():
        y, ld = icf.invconv_lu_forward(x, tlu)
        x_rec = icf.invconv_lu_reverse(y, tlu)
    assert icf.launches == {"invconv_forward": 1, "invconv_reverse": 1}
    assert y.shape == x.shape and x_rec.shape == x.shape
    assert torch.equal(y, ic.mix_channels(x, ic.lu_assemble(tlu)))
    assert torch.equal(ld, ic.lu_logdet(tlu))
    assert torch.equal(x_rec, ic.mix_channels(y, ic.lu_inverse(tlu)))


def test_path_chooser_at_the_checked_shapes():
    """The narrow kernel takes the cifar10 widths (and celeba64's first
    three) at any N; the wide and odd widths, and a misaligned view, take
    the tiled kernel."""
    want = {12: "narrow", 24: "narrow", 48: "narrow"}
    for n, c in icf.INVCONV_CASES:
        x = torch.empty(n, c)
        assert x.data_ptr() % 16 == 0
        assert icf.tensor_path(x) == want.get(c, "tiled"), (n, c)
    base = torch.empty(1025 * 12 + 1)
    assert icf.tensor_path(base[1:].view(1025, 12)) == "tiled"
    assert icf.tensor_path(base[:-1].view(1025, 12)) == "narrow"
    assert icf.mix_path(0, 12, True) == "tiled"
    assert icf.mix_path(7, 16, True) == "tiled"


def test_p_idx_follows_a_loaded_p():
    """`p_idx` is no `state_dict` entry; loading a state with another P
    refreshes it, and the plain forward then uses the new P."""
    conv = InvConv1x1LU(12, torch.Generator().manual_seed(1), impl="pallas")
    other = InvConv1x1LU(12, torch.Generator().manual_seed(2), impl="pallas")
    assert "p_idx" not in conv.state_dict()
    assert not torch.equal(conv.p_idx, other.p_idx)
    assert torch.equal(conv.p_idx, torch.argmax(conv.p, dim=1))
    conv.load_state_dict(other.state_dict())
    assert torch.equal(conv.p_idx, other.p_idx)
    assert torch.equal(conv.p_idx, torch.argmax(other.p, dim=1))
    x = torch.from_numpy(_x((1, 3, 3, 12), 25))
    assert torch.equal(conv(x)[0], other(x)[0])


@pytest.mark.cuda
def test_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels on one")
    _, tlu = _lu(48, seed=15)
    lu = ic.LUParams(*(t.cuda() for t in tlu))
    x = torch.from_numpy(_x((1025, 48), 16)).cuda()
    icf.reset_launches()
    y, _ = icf.invconv_lu_forward(x, lu)
    x_rec = icf.invconv_lu_reverse(y, lu)
    torch.cuda.synchronize()
    assert icf.launches == {"invconv_forward": 1, "invconv_reverse": 1}
    assert icf.path_launches == {"invconv_forward": {"narrow": 1, "tiled": 0},
                                 "invconv_reverse": {"narrow": 1, "tiled": 0}}
    y_ref = ic.mix_channels(x, ic.lu_assemble(lu))
    assert float((y - y_ref).abs().max()) <= 2e-5 * max(1.0, float(y_ref.abs().max()))
    assert float((x_rec - x).abs().max()) <= 2e-4
