"""The layouts around the flow-step chains' wgmma/TMA GEMM core
(`csrc/gemm_sm90.cuh`), on the CPU: the plain version of the conv1 patch
staging against the patches the coupling net's plain version reads (whole
images and row bands), the padded operand layout against the unpadded one
in `step_backward_ref`, and the core's plain version, with and without the
coupling net's actnorm-ReLU epilogue.  The kernels themselves run only on
the card (chip_smoke.py phase 17 and the kernel phases); the `cuda`-marked
tests here hold them when a card is present."""

import numpy as np
import pytest
import torch

from pytorch_glow_tpu_torch.ops import flowstep as tfs
from test_torch_flowstep_bwd import _noisy_step


def _z(shape, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("c", [4, 6, 12])
def test_staged_patches_are_conv1_patches_with_zero_pad(c):
    """9*ch = 18, 27, 54 columns, padded to 24, 32, 56."""
    step = _noisy_step(c, "affine")
    z1 = _z((3, 5, 7, c // 2))
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, False)
        p1 = tfs._net_parts(z1, weights, torch.bfloat16)[0]
        staged = tfs.stage_patches_ref(z1)
    n = 9 * (c // 2)
    assert staged.dtype == torch.bfloat16 and staged.shape == (3, 5, 7, tfs.padded(n))
    assert torch.equal(staged[..., :n].float(), p1)
    assert not staged[..., n:].any()


def test_staged_patches_on_bands_are_the_band_references_masked_taps():
    """Staged bands of 8x8 images, R = 4 rows with a 2-row halo: the halo
    rows outside the image read as zero, as the band reference masks them."""
    step = _noisy_step(6, "additive")
    z = _z((2, 8, 8, 6), seed=5)
    ext, valid = tfs._band_regions(z, 4, 0, 4)
    assert not valid.all()
    # Rows outside the image hold data the taps must not read.
    dirty = torch.where(valid[..., None, None], ext, 5.0)[..., :3]
    with torch.no_grad():
        weights = tfs.pack_weights(step, False, False)
        p1 = tfs._net_parts(dirty, weights, torch.bfloat16, valid)[0]
        staged = tfs.stage_patches_ref(dirty, torch.bfloat16, valid)
    assert torch.equal(staged, tfs.stage_patches_ref(ext[..., :3], torch.bfloat16))
    assert torch.equal(staged[..., :27].float(), p1)
    assert not staged[..., 27:].any()
    assert not torch.equal(staged, tfs.stage_patches_ref(dirty, torch.bfloat16))


@pytest.mark.parametrize("mode,c", [("affine", 6), ("additive", 6), ("affine", 4)])
def test_padded_layout_leaves_the_backward_unchanged(monkeypatch, mode, c):
    """`step_backward_ref` reads gy, the staged patches and w3t with rows
    padded to a multiple of 8 columns, the pad zero, as the kernel's GEMM
    core does; with no padding at all its outputs are the same."""
    affine = mode == "affine"
    step = _noisy_step(c, mode, seed=1)
    z, g_zn = _z((2, 5, 6, c), seed=3), _z((2, 5, 6, c), seed=4)
    g_ld = _z((2,), seed=5)
    with torch.no_grad():
        weights = tfs.pack_weights(step, affine, False)
        w3t = tfs.transposed_weights(weights)[2]
        assert w3t.shape[1] % 8 == 0 and w3t.shape[1] > weights[9].shape[0]
        assert not w3t[:, weights[9].shape[0]:].any()
        g_z, grads = tfs.step_backward_ref(weights, z, g_zn, g_ld, affine)
        monkeypatch.setattr(tfs, "padded", lambda n: n)
        g_z0, grads0 = tfs.step_backward_ref(weights, z, g_zn, g_ld, affine)
    for i, (a, b) in enumerate(zip((g_z, *grads), (g_z0, *grads0))):
        assert a.shape == b.shape, i
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-6, rtol=0,
                                   err_msg=str(i))


@pytest.mark.parametrize("trans,m,n,k", [(0, 70, 54, 27), (1, 54, 27, 70), (0, 9, 16, 512)])
def test_gemm_core_plain_version_reads_no_pad(trans, m, n, k):
    """Both operand orders: the product of the unpadded operands, whatever
    the pad columns hold; a CPU tensor never reaches the kernel."""
    gen = torch.Generator().manual_seed(trans + m)
    shapes = ((k, m), (k, n)) if trans else ((m, k), (n, k))
    a, b = (torch.full((rows, tfs.padded(cols)), 3.0).to(torch.bfloat16) for rows, cols in shapes)
    a[:, :shapes[0][1]] = torch.randn(shapes[0], generator=gen)
    b[:, :shapes[1][1]] = torch.randn(shapes[1], generator=gen)
    got = tfs.gemm_core(a, b, bool(trans), m, n, k)
    av, bv = a[:, :shapes[0][1]].float(), b[:, :shapes[1][1]].float()
    want = av.T @ bv if trans else av @ bv.T
    assert got.shape == (m, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [0, 1])
def test_gemm_core_matches_plain_version_on_the_card(trans):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the core on one")
    m, n, k = (300, 54, 512) if not trans else (108, 512, 3000)
    gen = torch.Generator().manual_seed(7)
    shapes = ((k, m), (k, n)) if trans else ((m, k), (n, k))
    a, b = (torch.zeros(rows, tfs.padded(cols), dtype=torch.bfloat16) for rows, cols in shapes)
    a[:, :shapes[0][1]] = torch.randn(shapes[0], generator=gen)
    b[:, :shapes[1][1]] = torch.randn(shapes[1], generator=gen)
    a, b = a.cuda(), b.cuda()
    got = tfs.gemm_core(a, b, bool(trans), m, n, k)
    want = tfs.gemm_core_ref(a, b, bool(trans), m, n, k)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def _epilogue_operands(m, n, k, seed, device="cpu"):
    """bf16 a (m, padded(k)) and b (n, padded(k)) with a pad the core must
    not read, and f32 (n,) bias and logs about the coupling net's."""
    gen = torch.Generator().manual_seed(seed)
    a, b = (torch.full((rows, tfs.padded(k)), 3.0).to(torch.bfloat16) for rows in (m, n))
    a[:, :k] = torch.randn(m, k, generator=gen)
    b[:, :k] = torch.randn(n, k, generator=gen) / k ** 0.5
    bias, logs = 0.5 * torch.randn(n, generator=gen), 0.2 * torch.randn(n, generator=gen)
    return (t.to(device) for t in (a, b, bias, logs))


@pytest.mark.parametrize("m,n,k", [(70, 32, 27), (9, 16, 512)])
def test_gemm_core_actnorm_relu_plain_version(m, n, k):
    """The conv epilogue's plain version: bf16(relu((a b^T + bias) e^logs))
    of the unpadded operands in f32, whatever the pad holds; a CPU tensor
    never reaches the kernel."""
    a, b, bias, logs = _epilogue_operands(m, n, k, seed=m)
    got = tfs.gemm_core(a, b, False, m, n, k, (bias, logs))
    prod = a[:, :k].float() @ b[:, :k].float().T
    want = torch.relu((prod + bias) * torch.exp(logs)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got, want) and bool((got == 0).any()) and bool((got > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(300, 512, 54), (1000, 512, 512), (90, 32, 72)])
def test_gemm_core_actnorm_relu_matches_plain_version_on_the_card(m, n, k):
    """The kernel's epilogue against its plain version: one bf16 rounding
    (2^-8 of the value) plus twice the f32 sum-order bound (1e-5 of the
    |a| |b| scale, times e^logs); a second launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the core on one")
    a, b, bias, logs = _epilogue_operands(m, n, k, seed=7, device="cuda")
    got = tfs.gemm_core(a, b, False, m, n, k, (bias, logs))
    again = tfs.gemm_core(a, b, False, m, n, k, (bias, logs))
    av, bv = a[:, :k].float(), b[:, :k].float()
    want = torch.relu((av @ bv.T + bias) * torch.exp(logs))
    scale = float((av.abs() @ bv.abs().T).max())
    bound = 2.0 ** -8 * want.abs() + 2e-5 * scale * torch.exp(logs)
    assert torch.equal(got, again)
    assert bool(((got.float() - want).abs() <= bound).all())
