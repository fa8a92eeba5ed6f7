"""The port's fused flow step (plain version on CPU) against the JAX kernel.

The JAX side runs `flowstep_pallas.step_forward` / `step_reverse` in
interpret mode, as its own tests do.  Bounds: at f32 coupling (both sides
patched to f32) the same math in another sum order, atol 1e-5; at bf16 the
repo's kernel bounds (tests/test_flowstep_pallas.py), because a bf16
rounding of h1/h2 flips wherever the f32 sums before it differ in order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu_torch.models.layers import FlowStep
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.utils.convert import _step as export_step

CFG = GlowConfig(image_shape=(8, 8, 3), hidden_channels=32, K=2, L=2,
                 compute_dtype="bfloat16", flowstep_impl="pallas")
SHAPES = [(12, 4, 4), (8, 6, 6), (24, 2, 2), (6, 5, 7), (16, 3, 5)]


def _pair(c: int, mode: str, seed: int = 0):
    """Noisy JAX step params (the `_noisy_step_params` pattern) and the same
    weights in a port FlowStep."""
    cfg = dataclasses.replace(CFG, flow_coupling=mode)
    sp = jglow._flow_step_init(jax.random.key(seed), c, cfg)
    sp = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(1), a.shape, a.dtype)
        if a.dtype == jnp.float32 else a,
        sp,
    )
    sd = {}
    export_step("s", jax.tree.map(np.asarray, sp), sd)
    step = FlowStep(c, cfg.hidden_channels, mode)
    step.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return sp, step


def _z(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def f32_coupling(monkeypatch):
    monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
    fsp._partitioned.cache_clear()
    yield torch.float32
    fsp._partitioned.cache_clear()


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_pack_weights_equal_jax(affine, reverse):
    sp, step = _pair(12, "affine" if affine else "additive")
    ours = tfs.pack_weights(step, affine, reverse)
    theirs = fsp.pack_weights(sp, "lu", affine, reverse)
    assert len(ours) == len(theirs) == tfs.N_WEIGHTS
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(b.dtype)], i
        assert tuple(a.shape) == b.shape, i
        got = a.detach().float().numpy()
        want = np.asarray(b, np.float32)
        if i == 0:  # the mix matrix: an LU product / triangular solves, f32
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"operand {i}")


@pytest.mark.parametrize("mode", ["affine", "additive"])
@pytest.mark.parametrize("c,h,w", SHAPES)
def test_step_ref_matches_jax_kernel_bf16(mode, c, h, w):
    affine = mode == "affine"
    sp, step = _pair(c, mode)
    z = _z((6, h, w, c))
    zj, ldj = fsp.step_forward(sp, jnp.asarray(z), "lu", affine)
    zt, ldt = tfs.step_forward_ref(tfs.pack_weights(step, affine, False), torch.from_numpy(z), affine)
    err = np.abs(zt.detach().numpy() - np.asarray(zj))
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), atol=5e-2, rtol=5e-2)
    assert err.mean() < 2e-3
    np.testing.assert_allclose(ldt.detach().numpy(), np.asarray(ldj), atol=2e-1, rtol=2e-2)
    xj = fsp.step_reverse(sp, zj, "lu", affine)
    xt = tfs.step_reverse_ref(tfs.pack_weights(step, affine, True), torch.from_numpy(np.array(zj)), affine)
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), atol=5e-2, rtol=5e-2)
    assert np.abs(xt.detach().numpy() - np.asarray(xj)).mean() < 2e-3


@pytest.mark.parametrize("mode", ["affine", "additive"])
@pytest.mark.parametrize("c,h,w", SHAPES)
def test_step_ref_matches_jax_kernel_f32(f32_coupling, mode, c, h, w):
    affine = mode == "affine"
    sp, step = _pair(c, mode)
    z = _z((6, h, w, c))
    zj, ldj = fsp.step_forward(sp, jnp.asarray(z), "lu", affine)
    wf = tfs.pack_weights(step, affine, False, coupling_dtype=f32_coupling)
    zt, ldt = tfs.step_forward_ref(wf, torch.from_numpy(z), affine, dtype=f32_coupling)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ldt.detach().numpy(), np.asarray(ldj), atol=1e-5, rtol=1e-6)
    xj = fsp.step_reverse(sp, zj, "lu", affine)
    wr = tfs.pack_weights(step, affine, True, coupling_dtype=f32_coupling)
    xt = tfs.step_reverse_ref(wr, torch.from_numpy(np.array(zj)), affine, dtype=f32_coupling)
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_step_roundtrip_exact(mode):
    affine = mode == "affine"
    _, step = _pair(12, mode, seed=3)
    z = torch.from_numpy(_z((4, 4, 4, 12), 3))
    with torch.no_grad():
        zn, _ = tfs.step_forward(tfs.pack_weights(step, affine, False), z, affine)
        rec = tfs.step_reverse(tfs.pack_weights(step, affine, True), zn, affine)
    np.testing.assert_allclose(rec.numpy(), z.numpy(), atol=2e-5, rtol=0)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, step = _pair(6, "affine")
    z = torch.from_numpy(_z((2, 3, 3, 6)))
    tfs.reset_launches()
    with torch.no_grad():
        out, ld = tfs.step_forward(tfs.pack_weights(step, True, False), z, True)
        ref, ref_ld = tfs.step_forward_ref(tfs.pack_weights(step, True, False), z, True)
    assert torch.equal(out, ref) and torch.equal(ld, ref_ld)
    assert tfs.launches == {"forward": 0, "reverse": 0, "backward": 0,
                            "band_forward": 0, "band_reverse": 0, "band_backward": 0,
                            "slab_forward": 0, "slab_reverse": 0, "slab_backward": 0}


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_launch_raises_on_cpu_tensor(reverse):
    _, step = _pair(6, "affine")
    z = torch.from_numpy(_z((2, 3, 3, 6)))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tfs._launch(tfs.pack_weights(step, True, reverse), z, True, reverse)


@pytest.mark.parametrize("mode", ["affine", "additive"])
@pytest.mark.parametrize("reverse", [False, True])
def test_padded_conv1_layout_matches_unpadded_and_jax_kernel(monkeypatch, f32_coupling, mode,
                                                              reverse):
    """The plain step reads conv1 as the GEMM core does: staged patches
    and w1 with `padded` columns, the pad zero (c = 6: 27 columns padded to
    32).  It agrees with the JAX kernel (`_make_kernel` in interpret mode)
    at f32 coupling, atol 1e-5, and with no padding at all it gives the
    same outputs, atol 1e-6."""
    affine = mode == "affine"
    sp, step = _pair(6, mode, seed=2)
    z = _z((3, 5, 7, 6), seed=4)
    weights = tfs.pack_weights(step, affine, reverse, coupling_dtype=f32_coupling)
    assert tfs.padded_w1(weights[3]).shape == (32, 32)

    def port():
        with torch.no_grad():
            if reverse:
                return (tfs.step_reverse_ref(weights, torch.from_numpy(z), affine, f32_coupling),)
            return tfs.step_forward_ref(weights, torch.from_numpy(z), affine, f32_coupling)

    got = port()
    if reverse:
        want = (fsp.step_reverse(sp, jnp.asarray(z), "lu", affine),)
    else:
        want = fsp.step_forward(sp, jnp.asarray(z), "lu", affine)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-6)
    monkeypatch.setattr(tfs, "padded", lambda n: n)
    for a, b in zip(got, port()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("c", [4, 6, 12, 16])
def test_padded_w1_zeros_its_pad(c):
    """9 * ch = 18, 27, 54, 72 columns: padded to 24, 32, 56 with a zero
    pad, and 72 taken as it is; the kernels' operand list swaps in that
    copy and nothing else."""
    _, step = _pair(c, "affine")
    weights = tfs.pack_weights(step, True, False)
    w1, n = weights[3], 9 * (c // 2)
    got = tfs.padded_w1(w1)
    assert got.dtype == w1.dtype and got.shape == (w1.shape[0], tfs.padded(n))
    assert got.shape[1] % 8 == 0 and got.is_contiguous()
    assert torch.equal(got[:, :n], w1) and not got[:, n:].any()
    assert (got is w1) == (n % 8 == 0)
    kernel = tfs._kernel_weights(weights)
    assert torch.equal(kernel[3], got)
    assert all(a is b for i, (a, b) in enumerate(zip(kernel, weights)) if i != 3)


@pytest.mark.parametrize("hidden", [4, 12, 20, 510])
def test_supported_refuses_hidden_not_a_multiple_of_8(hidden):
    """The GEMM core reads h1 and h2 rows through TMA, a multiple of 16
    bytes apart: such a shape fails at the chooser, not inside a launch."""
    assert tfs.supported(32, 32, 12, hidden - hidden % 8 or 8, True, b=64)
    assert not tfs.supported(32, 32, 12, hidden, True, b=64)
    for direction in ("forward", "reverse", "backward"):
        with pytest.raises(NotImplementedError, match="no flow-step kernel tiling"):
            tfs.tiling(direction, 64, 32, 32, 12, hidden)


def test_supported_shapes():
    for h, w, c in [(32, 32, 12), (16, 16, 24), (8, 8, 48), (4, 4, 96), (5, 7, 6)]:
        assert tfs.supported(h, w, c, 512, True, b=64)
    assert not tfs.supported(4, 4, 7, 512)  # odd channel count
    assert not tfs.supported(2048, 2048, 12, 512, b=8)  # beyond 32-bit indexing
