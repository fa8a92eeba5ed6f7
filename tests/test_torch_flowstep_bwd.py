"""The port's flow-step backward (plain version and autograd Function, on the
CPU) against autograd and against the JAX package's fused backward.

The JAX side runs `flowstep_pallas.step_backward_t` and the custom VJP of
`glow._fused_step_forward` in interpret mode, as its own tests do.  Bounds:
at f32 coupling, 3e-5 of each output's largest magnitude, the bound of
`test_fused_backward_kernel_exact_at_f32` (same math in another sum
order); at bf16, the repo's gradient bound atol = rtol = 5e-2 on
scale-normalised grads (tests/test_flowstep_pallas.py:120), because a bf16
rounding of h1, h2, gy, g_a2 or g_a1 flips wherever the f32 sums before it
run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu_torch.models.layers import FlowStep
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.utils.convert import _step as export_step
from test_torch_flowstep import _pair, _z


@pytest.fixture
def f32_coupling(monkeypatch):
    monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()
    yield torch.float32
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()


def _noisy_step(c, mode, seed=0):
    """A port FlowStep far from the identity, without the JAX side."""
    gen = torch.Generator().manual_seed(seed)
    step = FlowStep(c, 32, mode, torch.bfloat16, generator=gen)
    with torch.no_grad():
        for name, p in step.named_parameters():
            if not name.startswith("invconv."):
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return step


def _cotangents(b, h, w, c, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            rng.standard_normal((b,)).astype(np.float32))


def _assert_scaled_close(got, want, atol, rtol=0.0, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("mode,shape", [("affine", (6, 4, 4, 12)), ("additive", (5, 5, 7, 6))])
def test_backward_ref_is_autograd_of_forward_ref_f32(mode, shape):
    affine = mode == "affine"
    b, h, w, c = shape
    step = _noisy_step(c, mode)
    weights = [t.detach().requires_grad_() for t in tfs.pack_weights(step, affine, False, torch.float32)]
    z = torch.from_numpy(_z(shape)).requires_grad_()
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(*shape))
    zn, ld = tfs.step_forward_ref(weights, z, affine, torch.float32)
    want = torch.autograd.grad((zn * gzn).sum() + (ld * gld).sum(), [z, *weights])
    g_z, grads = tfs.step_backward_ref([t.detach() for t in weights], z.detach(), gzn, gld,
                                       affine, torch.float32)
    for i, (got, ref) in enumerate(zip([g_z, *grads], want)):
        assert got.shape == ref.shape, i
        _assert_scaled_close(got.numpy(), ref.numpy(), atol=3e-5, what=f"output {i}")


@pytest.mark.parametrize("mode,shape,precision", [
    ("affine", (6, 4, 4, 12), "f32"),
    ("additive", (6, 3, 5, 16), "f32"),
    ("affine", (6, 5, 7, 6), "bf16"),
    ("additive", (6, 4, 4, 12), "bf16"),
])
def test_backward_ref_matches_jax_kernel(request, mode, shape, precision):
    if precision == "f32":
        request.getfixturevalue("f32_coupling")
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    affine = mode == "affine"
    b, h, w, c = shape
    sp, _ = _pair(c, mode)
    packed = fsp.pack_weights(sp, "lu", affine, False)
    z = _z(shape)
    gzn, gld = _cotangents(*shape)
    g_packed, g_zt = fsp.step_backward_t(packed, fsp.to_t(jnp.asarray(z)), fsp.to_t(jnp.asarray(gzn)),
                                         jnp.asarray(gld), (h, w), b, affine)
    weights = [torch.from_numpy(np.array(p, np.float32)).to(dtype if i in (3, 6, 9) else torch.float32)
               for i, p in enumerate(packed)]
    g_z, grads = tfs.step_backward_ref(weights, torch.from_numpy(z), torch.from_numpy(gzn),
                                       torch.from_numpy(gld), affine, dtype)
    atol, rtol = (3e-5, 0.0) if precision == "f32" else (5e-2, 5e-2)
    _assert_scaled_close(g_z.numpy(), np.asarray(fsp.from_t(g_zt, shape)), atol, rtol, "g_z")
    for i, (got, ref) in enumerate(zip(grads, g_packed)):
        _assert_scaled_close(got.numpy(), ref, atol, rtol, f"weight grad {i}")


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_fused_step_function_grads_match_jax_custom_vjp(f32_coupling, mode):
    """Per-parameter grads of one step through `pack_weights` and
    `FusedStep` against `jax.grad` of `glow._fused_step_forward`."""
    affine = mode == "affine"
    b, h, w, c = 6, 4, 4, 12
    sp, step = _pair(c, mode)
    z = _z((b, h, w, c))
    gzn, gld = _cotangents(b, h, w, c)

    def loss(sp, zt):
        zn, ld = jglow._fused_step_forward(sp, zt, "lu", mode, (h, w), b)
        return jnp.sum(zn * fsp.to_t(jnp.asarray(gzn))) + jnp.sum(ld * gld)

    g_sp, g_zt = jax.grad(loss, argnums=(0, 1), allow_int=True)(sp, fsp.to_t(jnp.asarray(z)))
    g_sp = jax.tree.map(lambda g, p: p if g.dtype == jax.dtypes.float0 else g, g_sp, sp)
    want = {}
    export_step("s", jax.tree.map(np.asarray, g_sp), want)

    zt = torch.from_numpy(z).requires_grad_()
    packed = tfs.pack_weights(step, affine, False, f32_coupling)
    zn, ld = tfs.FusedStep.apply(zt, affine, None, *packed)
    ((zn * torch.from_numpy(gzn)).sum() + (ld * torch.from_numpy(gld)).sum()).backward()
    _assert_scaled_close(zt.grad.numpy(), np.asarray(fsp.from_t(g_zt, z.shape)), 3e-5, what="z")
    checked = 0
    for name, p in step.named_parameters():
        assert p.grad is not None, name
        _assert_scaled_close(p.grad.numpy(), want[f"s.{name}"], 3e-5, what=name)
        checked += 1
    assert checked == 14


def test_saturated_scales_give_finite_grads():
    """raw = -200 makes sigmoid(raw + 2) underflow to 0: the backward's
    saturation-safe g_raw keeps every gradient finite (the JAX package's
    `test_saturated_scale_gradients_finite`)."""
    b, h, w, c = 4, 4, 4, 12
    step = _noisy_step(c, "affine")
    with torch.no_grad():
        conv3 = step.f[4]
        conv3.weight.zero_()
        conv3.logs.zero_()
        conv3.bias[1::2] = -200.0  # the raw channels of the cross split
    z = torch.from_numpy(_z((b, h, w, c))).requires_grad_()
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(b, h, w, c))
    zn, ld = tfs.FusedStep.apply(z, True, None, *tfs.pack_weights(step, True, False))
    assert torch.isfinite(zn).all() and torch.isfinite(ld).all()
    ((zn * gzn).sum() + (ld * gld).sum()).backward()
    assert torch.isfinite(z.grad).all()
    for name, p in step.named_parameters():
        assert torch.isfinite(p.grad).all(), name


def test_backward_on_cpu_takes_plain_version_and_counts_no_launch():
    step = _noisy_step(6, "affine")
    weights = tfs.pack_weights(step, True, False)
    z = torch.from_numpy(_z((2, 3, 3, 6)))
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(2, 3, 3, 6))
    tfs.reset_launches()
    with torch.no_grad():
        g_z, grads = tfs.step_backward(weights, z, gzn, gld, True)
        r_z, r_grads = tfs.step_backward_ref(weights, z, gzn, gld, True)
    assert torch.equal(g_z, r_z) and all(torch.equal(a, r) for a, r in zip(grads, r_grads))
    assert tfs.launches == {"forward": 0, "reverse": 0, "backward": 0,
                            "band_forward": 0, "band_reverse": 0, "band_backward": 0,
                            "slab_forward": 0, "slab_reverse": 0, "slab_backward": 0}


def test_backward_kernel_entry_raises_on_cpu_tensor():
    step = _noisy_step(6, "affine")
    z = torch.from_numpy(_z((2, 3, 3, 6)))
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(2, 3, 3, 6))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tfs._launch_backward(tfs.pack_weights(step, True, False), z, gzn, gld, True)


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_fused_reverse_function_grads_match_layer_autograd(mode):
    """`FusedStepReverse`'s backward (autograd over the plain reverse) at f32
    coupling against autograd through the unfused layer's reverse, which
    computes the same function with f32 convolutions: 1e-5 of scale."""
    step = _noisy_step(6, mode)
    step.compute_dtype = torch.float32
    z = torch.from_numpy(_z((2, 3, 5, 6))).requires_grad_()
    g = torch.from_numpy(_cotangents(2, 3, 5, 6)[0])
    out = tfs.FusedStepReverse.apply(z, mode == "affine", None,
                                     *tfs.pack_weights(step, mode == "affine", True, torch.float32))
    got = torch.autograd.grad(out, [z, *step.parameters()], g)
    want = torch.autograd.grad(step.reverse(z), [z, *step.parameters()], g)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_scaled_close(a.numpy(), b.numpy(), atol=1e-5, what=f"input {i}")
