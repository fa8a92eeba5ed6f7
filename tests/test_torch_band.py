"""The port's row-band flow step (K4/K5's plain versions, on the CPU): the
tiling chooser's outcomes, the band versions against the whole-batch ones,
and against the JAX package's halo kernels in interpret mode.

`BAND_PIXELS` and `STAGING_BUDGET_BYTES` are patched small so that a 32x32
image takes bands of R = 8 rows, as the JAX tests shrink `MAX_TILE_COLS`
(tests/test_flowstep_pallas.py:126-133), with several groups of bands per
call.  Bounds: at f32 coupling the same math in another sum order, atol
1e-5 (backward 3e-5 of each output's largest magnitude, the bound of
`test_fused_backward_halo_exact_at_f32`); at bf16 the repo's kernel and
gradient bounds, because a bf16 rounding of h1/h2 flips wherever the f32
sums before it run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu_torch import PRESETS
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.utils.convert import _step as export_step
from test_torch_flowstep import _pair, _z
from test_torch_flowstep_bwd import _assert_scaled_close, _cotangents, _noisy_step

SHAPE = (5, 32, 32, 12)  # b, h, w, c; hidden 32
GIB = 2**30


@pytest.fixture
def small_bands(monkeypatch):
    """Bands of 8 rows at 32x32 (256 centre pixels) and a budget of 2 to 9
    bands per launch, so every call runs several groups of several bands."""
    monkeypatch.setattr(tfs, "BAND_PIXELS", 256)
    monkeypatch.setattr(tfs, "STAGING_BUDGET_BYTES", 1_600_000)
    b, h, w, c = SHAPE
    for direction in ("forward", "reverse", "backward"):
        for affine in (True, False):
            assert tfs.tiling(direction, b, h, w, c, 32, affine) == "band"
    assert tfs.band_rows(h, w) == 8


@pytest.fixture
def force_halo(monkeypatch):
    """The JAX package's own switch to its halo kernels at 32x32."""
    monkeypatch.setattr(fsp, "MAX_TILE_COLS", 512)
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()
    assert fsp._halo_rows(32, 32, 12, 32) == 8
    yield
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()


@pytest.fixture
def f32_coupling(monkeypatch):
    monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()
    yield torch.float32
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()


# -- the chooser -------------------------------------------------------------


def _levels(name):
    cfg = PRESETS[name].glow
    return cfg.latent_shapes(), cfg.flow_coupling == "affine"


@pytest.mark.parametrize("name,batch", [("celeba64", 128), ("celeba64", 64), ("cifar10", 256)])
def test_chooser_keeps_flagship_presets_whole(name, batch):
    shapes, affine = _levels(name)
    for h, w, c in shapes:
        for direction in ("forward", "reverse", "backward"):
            assert tfs.tiling(direction, batch, h, w, c, 512, affine) == "whole", (h, w, c, direction)
    # celeba64 level 0 backward at its training batch: about 0.69 GB staged.
    assert 0.6e9 < tfs.bwd_workspace_bytes(128 * 32 * 32, 12, 512, True) < 0.75e9


def test_chooser_celebahq256_at_b64():
    shapes, affine = _levels("celebahq256")
    assert not affine and shapes[:2] == [(128, 128, 12), (64, 64, 24)]
    want = {0: ("band", "band", "band"), 1: ("whole", "whole", "band")}
    for i, (h, w, c) in enumerate(shapes):
        got = tuple(tfs.tiling(d, 64, h, w, c, 512, affine) for d in ("forward", "reverse", "backward"))
        assert got == want.get(i, ("whole",) * 3), (i, got)
    # Level 1: about 0.71 GB staged forward (conv1's padded patches p1
    # included), about 1.48 GB backward.
    assert 0.65e9 < tfs._staging_bytes("forward", 64 * 64 * 64, 24, 512, False) < 0.75e9
    assert 1.4e9 < tfs.bwd_workspace_bytes(64 * 64 * 64, 24, 512, False) < 1.6e9
    assert tfs.band_rows(128, 128) == 32 and tfs.band_rows(64, 64) == 64
    for direction in ("forward", "reverse", "backward"):
        g = tfs.bands_per_launch(direction, 64, 128, 128, 12, 512, False)
        assert 1 < g < 256
        assert tfs._band_staging_bytes(direction, g, 32, 128, 12, 512, False) <= GIB
        assert tfs._band_staging_bytes(direction, g + 1, 32, 128, 12, 512, False) > GIB


@pytest.mark.parametrize("affine,want", [(False, (94, 94, 44)), (True, (86, 86, 41))])
def test_chooser_band_groups_at_celebahq256_level0(affine, want):
    """G at 128x128x12, b=64 (R = 32, 36 x 128 staged pixels a band): the
    forward and reverse stage conv1's patches p1 (2 * padded(54) = 112 bytes
    a pixel), 516,096 bytes a band, so G is 94 additive (was 98) and 86
    affine (was 90); the backward's workspace already held p1."""
    got = tuple(tfs.bands_per_launch(d, 64, 128, 128, 12, 512, affine)
                for d in ("forward", "reverse", "backward"))
    assert got == want
    per_pixel = 4 * 512 + 36 * (12 if affine else 6)  # h1, h2, y
    assert tfs._net_bytes(36 * 128, 12, 512, affine) - 36 * 128 * per_pixel == 516_096
    for direction, g in zip(("forward", "reverse"), want):
        assert tfs._band_staging_bytes(direction, g, 32, 128, 12, 512, affine) <= GIB
        assert tfs._band_staging_bytes(direction, g + 1, 32, 128, 12, 512, affine) > GIB


def test_chooser_b256_at_128x128_takes_bands_and_32bit_limits():
    for direction in ("forward", "reverse", "backward"):
        assert tfs.tiling(direction, 256, 128, 128, 12, 512, False) == "band"
    assert not tfs._fits_int32(256 * 128 * 128, 12, 512, False)
    assert tfs.supported(128, 128, 12, 512, False, b=256)
    # Bands index in 32 bits where the whole batch does not; one 2052-row
    # band of a 2048x2048 image does not either.
    assert tfs.supported(512, 512, 12, 512, b=64) and not tfs._fits_int32(64 * 512 * 512, 12, 512, True)
    assert not tfs.supported(2048, 2048, 12, 512, b=8)
    assert not tfs.supported(4, 4, 7, 512)
    with pytest.raises(NotImplementedError, match="no flow-step kernel tiling"):
        tfs.tiling("forward", 1, 4, 4, 7, 512)


def test_band_rows_rules(monkeypatch):
    assert tfs.band_rows(64, 64) == 64  # h * w <= BAND_PIXELS: the whole image
    assert tfs.band_rows(96, 100) == 32  # largest divisor with R * w <= 4096
    assert tfs.band_rows(97, 100) == 97  # no divisor qualifies
    monkeypatch.setattr(tfs, "BAND_PIXELS", 256)
    assert tfs.band_rows(32, 32) == 8 and tfs.band_rows(20, 16) == 10 and tfs.band_rows(20, 64) == 4


# -- band versions against the whole-batch plain versions ---------------------


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_band_versions_match_whole_f32(small_bands, mode):
    affine = mode == "affine"
    b, h, w, c = SHAPE
    step = _noisy_step(c, mode)
    wf = tfs.pack_weights(step, affine, False, torch.float32)
    wr = tfs.pack_weights(step, affine, True, torch.float32)
    for direction in ("forward", "reverse", "backward"):
        g = tfs.bands_per_launch(direction, b, h, w, c, 32, affine)
        assert 1 < g < 20, (direction, g)  # several groups of several bands
    z = torch.from_numpy(_z(SHAPE))
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(*SHAPE))
    with torch.no_grad():
        zb, ldb = tfs.step_forward_band_ref(wf, z, affine, torch.float32)
        zw, ldw = tfs.step_forward_ref(wf, z, affine, torch.float32)
        np.testing.assert_allclose(zb.numpy(), zw.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ldb.numpy(), ldw.numpy(), atol=1e-5, rtol=1e-6)
        xb = tfs.step_reverse_band_ref(wr, zw, affine, torch.float32)
        xw = tfs.step_reverse_ref(wr, zw, affine, torch.float32)
        np.testing.assert_allclose(xb.numpy(), xw.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(xb.numpy(), z.numpy(), atol=2e-5, rtol=0)
        gb, grads_b = tfs.step_backward_band_ref(wf, z, gzn, gld, affine, torch.float32)
        gw, grads_w = tfs.step_backward_ref(wf, z, gzn, gld, affine, torch.float32)
    _assert_scaled_close(gb.numpy(), gw.numpy(), 1e-5, what="g_z")
    for i, (a, r) in enumerate(zip(grads_b, grads_w)):
        _assert_scaled_close(a.numpy(), r.numpy(), 1e-5, what=f"weight grad {i}")


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_band_forward_bitwise_whole_at_bf16(small_bands, mode):
    """A centre row's patches, h1, h2 and y are the whole image's values, so
    the band output equals the whole output bit for bit, as on the card."""
    affine = mode == "affine"
    step = _noisy_step(SHAPE[-1], mode)
    z = torch.from_numpy(_z(SHAPE))
    with torch.no_grad():
        wf = tfs.pack_weights(step, affine, False)
        zb, _ = tfs.step_forward_band_ref(wf, z, affine)
        zw, _ = tfs.step_forward_ref(wf, z, affine)
        wr = tfs.pack_weights(step, affine, True)
        xb = tfs.step_reverse_band_ref(wr, zw, affine)
        xw = tfs.step_reverse_ref(wr, zw, affine)
    assert torch.equal(zb, zw) and torch.equal(xb, xw)


def test_band_backward_adds_nothing_across_images(small_bands):
    """Cotangents of one image give the other images' g_z exact zeros (the
    halo rows outside an image and the fold across image boundaries add
    nothing), and g_ld enters only through its own image."""
    b, h, w, c = SHAPE
    step = _noisy_step(c, "affine")
    wf = tfs.pack_weights(step, True, False)
    z = torch.from_numpy(_z(SHAPE))
    gzn = torch.zeros(SHAPE)
    gzn[1] = torch.from_numpy(_cotangents(*SHAPE)[0][1])
    gld = torch.tensor([0.0, 1.5, 0.0, 0.0, 0.0])
    with torch.no_grad():
        g_z, _ = tfs.step_backward_band_ref(wf, z, gzn, gld, True)
    assert torch.equal(g_z[0], torch.zeros_like(g_z[0])) and torch.equal(g_z[2], torch.zeros_like(g_z[2]))
    assert float(g_z[1].abs().max()) > 0


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_band_forward_patches_mask_dirty_rows_outside_the_image(small_bands, mode):
    """A band group's mixed z is not zero on rows outside the image (the
    mix adds the actnorm bias to the staged zeros, and the kernel's scratch
    is never cleared): conv1's staged patches, h1, h2 and f() there equal
    those of the zeroed rows, and the patches equal the band reference's
    masked taps, the pad columns zero.  Without the mask they differ."""
    affine = mode == "affine"
    step = _noisy_step(12, mode, seed=4)
    z = torch.from_numpy(_z(SHAPE, 8))
    ext, valid = tfs._band_regions(z, tfs.band_rows(32, 32), 2, 4)  # image 0's last two bands
    assert not valid.all() and valid.any()
    dirty = torch.where(valid[..., None, None], ext, 3.0)[..., :6]
    with torch.no_grad():
        weights = tfs.pack_weights(step, affine, False)
        got = tfs._net_parts(dirty, weights, torch.bfloat16, valid)
        want = tfs._net_parts(ext[..., :6], weights, torch.bfloat16, valid)
        staged = tfs.stage_patches_ref(dirty, torch.bfloat16, valid)
        unmasked = tfs._net_parts(dirty, weights, torch.bfloat16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(staged, tfs.stage_patches_ref(ext[..., :6], torch.bfloat16))
    assert torch.equal(staged[..., :54].float(), got[0]) and not staged[..., 54:].any()
    assert not torch.equal(unmasked[0], got[0])


def test_step_entries_route_by_tiling_on_cpu(small_bands):
    """`step_*` take the band versions when `tiling()` says band, on CPU
    tensors too, and launch nothing."""
    step = _noisy_step(SHAPE[-1], "additive")
    z = torch.from_numpy(_z(SHAPE))
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(*SHAPE))
    wf, wr = tfs.pack_weights(step, False, False), tfs.pack_weights(step, False, True)
    tfs.reset_launches()
    with torch.no_grad():
        out, ld = tfs.step_forward(wf, z, False)
        ref, ref_ld = tfs.step_forward_band_ref(wf, z, False)
        assert torch.equal(out, ref) and torch.equal(ld, ref_ld)
        assert torch.equal(tfs.step_reverse(wr, out, False), tfs.step_reverse_band_ref(wr, out, False))
        g_z, grads = tfs.step_backward(wf, z, gzn, gld, False)
        r_z, r_grads = tfs.step_backward_band_ref(wf, z, gzn, gld, False)
    assert torch.equal(g_z, r_z) and all(torch.equal(a, r) for a, r in zip(grads, r_grads))
    assert set(tfs.launches.values()) == {0}
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tfs._launch_band(wf, z, False, False)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tfs._launch_band_backward(wf, z, gzn, gld, False)


# -- band versions against the JAX halo kernels --------------------------------


@pytest.mark.parametrize("mode", ["affine", "additive"])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_band_versions_match_jax_halo_kernel(request, small_bands, force_halo, mode, precision):
    dtype = torch.bfloat16
    if precision == "f32":
        dtype = request.getfixturevalue("f32_coupling")
    affine = mode == "affine"
    sp, step = _pair(12, mode)
    z = _z(SHAPE)
    zj, ldj = fsp.step_forward(sp, jnp.asarray(z), "lu", affine)
    xj = fsp.step_reverse(sp, zj, "lu", affine)
    wf = tfs.pack_weights(step, affine, False, dtype)
    wr = tfs.pack_weights(step, affine, True, dtype)
    with torch.no_grad():
        zt, ldt = tfs.step_forward_band_ref(wf, torch.from_numpy(z), affine, dtype)
        xt = tfs.step_reverse_band_ref(wr, torch.from_numpy(np.array(zj)), affine, dtype)
        rt = tfs.step_reverse_band_ref(wr, zt, affine, dtype)
    np.testing.assert_allclose(rt.numpy(), z, atol=2e-5, rtol=0)  # per-step round-trip
    if precision == "f32":
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=0)
        return
    for got, want in ((zt.numpy(), np.asarray(zj)), (xt.numpy(), np.asarray(xj))):
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
        assert np.abs(got - want).mean() < 2e-3
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=2e-1, rtol=2e-2)


@pytest.mark.parametrize("mode", ["affine", "additive"])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_band_backward_matches_jax_halo_kernel(request, small_bands, force_halo, mode, precision):
    dtype = torch.bfloat16
    if precision == "f32":
        dtype = request.getfixturevalue("f32_coupling")
    affine = mode == "affine"
    b, h, w, c = SHAPE
    assert not fsp._bwd_whole_image_ok(h, w, c, 32, b)
    assert fsp._bwd_halo_rows(h, w, c, 32, affine) is not None
    sp, _ = _pair(c, mode)
    packed = fsp.pack_weights(sp, "lu", affine, False)
    z = _z(SHAPE)
    gzn, gld = _cotangents(*SHAPE)
    g_packed, g_zt = fsp.step_backward_t(packed, fsp.to_t(jnp.asarray(z)), fsp.to_t(jnp.asarray(gzn)),
                                         jnp.asarray(gld), (h, w), b, affine)
    weights = [torch.from_numpy(np.array(p, np.float32)).to(dtype if i in (3, 6, 9) else torch.float32)
               for i, p in enumerate(packed)]
    with torch.no_grad():
        g_z, grads = tfs.step_backward_band_ref(weights, torch.from_numpy(z), torch.from_numpy(gzn),
                                                torch.from_numpy(gld), affine, dtype)
    atol, rtol = (3e-5, 0.0) if precision == "f32" else (5e-2, 5e-2)
    _assert_scaled_close(g_z.numpy(), np.asarray(fsp.from_t(g_zt, SHAPE)), atol, rtol, "g_z")
    for i, (got, ref) in enumerate(zip(grads, g_packed)):
        _assert_scaled_close(got.numpy(), ref, atol, rtol, f"weight grad {i}")


@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_fused_step_grads_on_bands_match_jax_custom_vjp(small_bands, force_halo, f32_coupling, mode):
    """Per-parameter grads of one step through `FusedStep` on the band path
    against `jax.grad` of `glow._fused_step_forward` on the halo kernels."""
    affine = mode == "affine"
    b, h, w, c = SHAPE
    sp, step = _pair(c, mode)
    z = _z(SHAPE)
    gzn, gld = _cotangents(*SHAPE)

    def loss(sp, zt):
        zn, ld = jglow._fused_step_forward(sp, zt, "lu", mode, (h, w), b)
        return jnp.sum(zn * fsp.to_t(jnp.asarray(gzn))) + jnp.sum(ld * gld)

    g_sp, g_zt = jax.grad(loss, argnums=(0, 1), allow_int=True)(sp, fsp.to_t(jnp.asarray(z)))
    g_sp = jax.tree.map(lambda g, p: p if g.dtype == jax.dtypes.float0 else g, g_sp, sp)
    want = {}
    export_step("s", jax.tree.map(np.asarray, g_sp), want)

    zt = torch.from_numpy(z).requires_grad_()
    zn, ld = tfs.FusedStep.apply(zt, affine, None, *tfs.pack_weights(step, affine, False, f32_coupling))
    ((zn * torch.from_numpy(gzn)).sum() + (ld * torch.from_numpy(gld)).sum()).backward()
    _assert_scaled_close(zt.grad.numpy(), np.asarray(fsp.from_t(g_zt, z.shape)), 3e-5, what="z")
    for name, p in step.named_parameters():
        _assert_scaled_close(p.grad.numpy(), want[f"s.{name}"], 3e-5, what=name)
