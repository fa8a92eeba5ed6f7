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
from pytorch_glow_tpu_torch.ops import invconv as ic
from pytorch_glow_tpu_torch.ops import invconv_fused as icf


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


@pytest.mark.parametrize("c,n", [(12, 64), (48, 1000), (48, 1024)])
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


def test_reverse_roundtrip_and_matches_jax_kernel():
    jlu, tlu = _lu(48, seed=7)
    x = _x((4, 4, 4, 48), 8)
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


def test_autograd_functions_match_plain_autograd(monkeypatch):
    """The Functions' backward (the plain f32 math the card runs after the
    kernels) against autograd of the plain version: the launches swapped
    for their plain versions, as only the card can run them."""
    monkeypatch.setattr(icf, "_launch_forward", lambda x2d, lu: (
        ic.mix_channels(x2d, ic.lu_assemble(lu)), ic.lu_assemble(lu)))
    monkeypatch.setattr(icf, "_launch_mix", ic.mix_channels)
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
        icf._launch_forward(x.view(-1, 12), tlu)
    with pytest.raises(ValueError, match="CUDA"):
        icf._launch_mix(x.view(-1, 12), torch.eye(12))


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
    y_ref = ic.mix_channels(x, ic.lu_assemble(lu))
    assert float((y - y_ref).abs().max()) <= 2e-5 * max(1.0, float(y_ref.abs().max()))
    assert float((x_rec - x).abs().max()) <= 2e-4
