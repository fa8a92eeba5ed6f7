"""The port's anatomy variants S1-S3 (plain versions, on the CPU) against the
variant kernels of the JAX package's anatomy scripts.

The JAX side loads `scripts/perf_kernel_anatomy.py`, `perf_reverse_anatomy.py`
and `perf_bwd_anatomy.py` by file path and builds their `pallas_call` as
their `run_variant` does, with one tile (tb = b, grid 1), in interpret mode;
S3's `full` is the production `flowstep_pallas._make_bwd_kernel`, as there.
Both sides take the same packed weights at f32 coupling (the JAX side's
COUPLING_DTYPE patched), so what differs is the sum order: atol 1e-5, the
bound of `test_step_ref_matches_jax_kernel_f32`, on each output over its
largest magnitude where that passes 1 (the grads sum 128 pixels).  The JAX
layout is (C, N), the port's (B, H, W, C).

`matmul_only` is held only against its plain version, on the card: the JAX
variant reads its conv1 patch scratch without writing it
(`perf_kernel_anatomy.py:68`, `perf_reverse_anatomy.py:64`,
`perf_bwd_anatomy.py:92`), so its output is not defined; the port's
variant reads a staged patch tensor the caller makes.

`no_accum` is the JAX variant's: each batch tile of the JAX backward
(`anatomy.bwd_tile_batch`, a copy of `flowstep_pallas._bwd_tile_batch`)
overwrites the weight grads, which keep the last tile's contribution.
`test_no_accum_matches_jax_variant_at_two_tiles` holds it to the JAX
variant at MULTI_TILE_SHAPE, where the JAX grid has two tiles; at the
other shapes one tile spans the batch and both equal `full`.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu_torch.ops import anatomy as an
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from test_torch_flowstep import _pair, _z

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {"forward": "perf_kernel_anatomy", "reverse": "perf_reverse_anatomy",
           "backward": "perf_bwd_anatomy"}
TABLES = {"forward": an.FORWARD, "reverse": an.REVERSE, "backward": an.BACKWARD}
SHAPE = (2, 8, 8, 4)  # b, h, w, c; hidden 32 (test_torch_flowstep.CFG)
# no_accum: at 2x4x4 one JAX batch tile spans the batch; at 32x16x16x4
# (hidden 32) a tile is 16 images, so the JAX grid has two.
SINGLE_CHUNK_SHAPE = (2, 4, 4, 4)
MULTI_TILE_SHAPE = (32, 16, 16, 4)
CASES = [(d, v) for d, table in TABLES.items() for v in table if v != "matmul_only"]


@functools.cache
def _script(direction: str):
    name = SCRIPTS[direction]
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def f32_coupling(monkeypatch):
    monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
    yield torch.float32


def _jax_variant(direction: str, variant: str, weights, z: np.ndarray, g_zn=None, g_ld=None,
                 tb=None):
    """The script's variant kernel in interpret mode, one tile (or, for the
    backward, tiles of `tb` images as its `run_variant` cuts them): NHWC
    numpy in, NHWC (and logdet, or the 12 grads) out."""
    b, h, w, c = z.shape
    tb = tb or b
    total, ch, hidden = b * h * w, c // 2, weights[3].shape[0]
    n = tb * h * w
    ws = [jnp.asarray(t.float().numpy()) for t in weights]
    rep = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: (0,) * len(shape), memory_space=pltpu.VMEM)
    zspec = pl.BlockSpec((c, n), lambda i: (0, i), memory_space=pltpu.VMEM)
    scratch = [pltpu.VMEM((9 * ch, n), fsp.COUPLING_DTYPE),
               pltpu.VMEM((hidden, n), fsp.COUPLING_DTYPE),
               pltpu.VMEM((hidden, n), fsp.COUPLING_DTYPE)]
    f32 = jnp.float32

    def cn(x):
        return jnp.asarray(x.reshape(total, c).T)

    def nhwc(x):
        return np.asarray(x).T.reshape(b, h, w, c)

    if direction != "backward":
        kernel = _script(direction)._make_variant(variant, b, h, w, c, hidden)
        zn, ld = pl.pallas_call(
            kernel, grid=(1,), in_specs=[zspec] + [rep(x.shape) for x in ws],
            out_specs=[zspec, pl.BlockSpec((b, 128), lambda i: (0, 0), memory_space=pltpu.VMEM)],
            out_shape=[jax.ShapeDtypeStruct((c, n), f32), jax.ShapeDtypeStruct((b, 128), f32)],
            scratch_shapes=scratch, interpret=fsp._interpret(),
        )(cn(z), *ws)
        return nhwc(zn), np.asarray(ld)[:, 0]
    if variant == "full":
        kernel = fsp._make_bwd_kernel(tb, h, w, c, hidden, True)
    else:
        kernel = _script(direction)._make_variant(variant, tb, h, w, c, hidden)
    shapes = [tuple(x.shape) for x in ws]
    gld = jnp.asarray(np.repeat(g_ld, h * w)[None])
    outs = pl.pallas_call(
        kernel, grid=(b // tb,),
        in_specs=[zspec] + [rep(x.shape) for x in ws]
        + [zspec, pl.BlockSpec((1, n), lambda i: (0, i), memory_space=pltpu.VMEM)],
        out_specs=[zspec] + [rep(s) for s in shapes],
        out_shape=[jax.ShapeDtypeStruct((c, total), f32)] + [jax.ShapeDtypeStruct(s, f32)
                                                             for s in shapes],
        scratch_shapes=scratch + [pltpu.VMEM((hidden, n), f32), pltpu.VMEM((hidden, n), f32),
                                  pltpu.VMEM((9 * c, n), fsp.COUPLING_DTYPE)],
        interpret=fsp._interpret(),
    )(cn(z), *ws, cn(g_zn), gld)
    return nhwc(outs[0]), [np.asarray(o) for o in outs[1:]]


def _close(got, want, what: str):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5, rtol=0, err_msg=what)


def _inputs(shape):
    z, g_zn = _z(shape), _z(shape, seed=3)
    g_ld = np.random.default_rng(4).standard_normal(shape[0]).astype(np.float32)
    return z, g_zn, g_ld


@pytest.mark.parametrize("direction,variant", CASES)
def test_plain_variant_matches_jax_script_kernel_f32(f32_coupling, direction, variant):
    shape = SINGLE_CHUNK_SHAPE if variant == "no_accum" else SHAPE
    _, step = _pair(shape[-1], "affine")
    z, g_zn, g_ld = _inputs(shape)
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, direction == "reverse", f32_coupling)
        if direction == "forward":
            got, ld = an.forward_variant(variant, weights, torch.from_numpy(z))
            want, want_ld = _jax_variant(direction, variant, weights, z)
            _close(ld.numpy(), want_ld, "logdet")
        elif direction == "reverse":
            got = an.reverse_variant(variant, weights, torch.from_numpy(z))
            want, _ = _jax_variant(direction, variant, weights, z)
        else:
            got, grads = an.backward_variant(variant, weights, *map(torch.from_numpy,
                                                                    (z, g_zn, g_ld)))
            want, want_grads = _jax_variant(direction, variant, weights, z, g_zn, g_ld)
            for i, (g, wg) in enumerate(zip(grads, want_grads)):
                assert tuple(g.shape) == wg.shape, i
                _close(g.numpy(), wg, f"weight grad {i}")
    _close(got.numpy(), want, "z output")


@pytest.mark.parametrize("direction", list(TABLES))
def test_plain_full_is_the_production_plain_version_bitwise(direction):
    _, step = _pair(4, "affine", seed=5)
    z, g_zn, g_ld = map(torch.from_numpy, _inputs(SHAPE))
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, direction == "reverse")
        if direction == "forward":
            got = an.forward_variant_ref("full", weights, z)
            want = tfs.step_forward_ref(weights, z, True)
        elif direction == "reverse":
            got = (an.reverse_variant_ref("full", weights, z),)
            want = (tfs.step_reverse_ref(weights, z, True),)
        else:
            g_z, grads = an.backward_variant_ref("full", weights, z, g_zn, g_ld)
            rz, rgrads = tfs.step_backward_ref(weights, z, g_zn, g_ld, True)
            got, want = (g_z, *grads), (rz, *rgrads)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("variant", ["recip_exp", "split_mix"])
def test_correct_math_reverse_variants_match_step_reverse_ref(variant):
    _, step = _pair(4, "affine", seed=6)
    z = torch.from_numpy(_z(SHAPE, seed=7))
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, True)
        got = an.reverse_variant_ref(variant, weights, z)
        want = tfs.step_reverse_ref(weights, z, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_no_accum_at_several_chunks_keeps_g_z_and_the_single_chunk_sums():
    """At MULTI_TILE_SHAPE (two JAX batch tiles of 16 images) no_accum keeps
    `full`'s g_z, and its grads are `full`'s over the last tile's images
    run as a batch of their own: the sums of that tile alone."""
    assert an.bwd_tile_batch(*MULTI_TILE_SHAPE, 32) == 16
    _, step = _pair(4, "affine")
    z, g_zn, g_ld = map(torch.from_numpy, _inputs(MULTI_TILE_SHAPE))
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, False)
        g_z, grads = an.backward_variant_ref("no_accum", weights, z, g_zn, g_ld)
        rz, rgrads = an.backward_variant_ref("full", weights, z, g_zn, g_ld)
        _, tile_grads = an.backward_variant_ref("full", weights, z[16:], g_zn[16:], g_ld[16:])
    assert torch.equal(g_z, rz)
    for i, (g, t, r) in enumerate(zip(grads, tile_grads, rgrads)):
        _close(g.numpy(), t.numpy(), f"weight grad {i}")
        assert not torch.allclose(g, r), i


def test_no_accum_matches_jax_variant_at_two_tiles(f32_coupling):
    """no_accum against the JAX script's variant kernel run as its
    `run_variant` runs it, grid b // tb = 2 tiles, in interpret mode."""
    b = MULTI_TILE_SHAPE[0]
    tb = an.bwd_tile_batch(*MULTI_TILE_SHAPE, 32)
    assert tb == fsp._bwd_tile_batch(*MULTI_TILE_SHAPE, 32) == b // 2
    _, step = _pair(4, "affine")
    z, g_zn, g_ld = _inputs(MULTI_TILE_SHAPE)
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, False, f32_coupling)
        got, grads = an.backward_variant("no_accum", weights,
                                         *map(torch.from_numpy, (z, g_zn, g_ld)))
        want, want_grads = _jax_variant("backward", "no_accum", weights, z, g_zn, g_ld, tb)
    _close(got.numpy(), want, "z output")
    for i, (g, wg) in enumerate(zip(grads, want_grads)):
        _close(g.numpy(), wg, f"weight grad {i}")


@pytest.mark.parametrize("kind,affine,want_ms,want_by", [
    ("forward", True, 0.09203232061524531, "operations"),
    ("reverse", True, 0.09203232061524531, "operations"),
    ("backward", True, 0.2777872037561837, "operations"),
    ("forward", False, 0.08470395124011892, "operations"),
    ("forward", True, 0.00020915701492537313, "bytes"),
])
def test_bound_at_the_anatomy_shape(kind, affine, want_ms, want_by):
    """The roofline bound the anatomy tables and chip_smoke.py share, at
    celeba64 level 0 (b=128, 32x32x12, hidden 512), and one bytes-bound
    case (b=1, 4x4x12)."""
    b, h, w = (128, 32, 32) if want_by == "operations" else (1, 4, 4)
    ms, by = tfs.bound_ms(kind, b, h, w, 12, 512, affine)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-12)


def test_matmul_only_needs_staged_patches():
    _, step = _pair(4, "affine")
    z = torch.from_numpy(_z(SHAPE))
    with torch.no_grad(), pytest.raises(ValueError, match="staged patches"):
        an.forward_variant("matmul_only", tfs.pack_weights(step, True, False), z)


@pytest.mark.parametrize("direction", list(TABLES))
def test_cpu_tensor_takes_plain_version_and_never_reaches_the_kernel(direction):
    _, step = _pair(4, "affine")
    z, g_zn, g_ld = map(torch.from_numpy, _inputs(SHAPE))
    patches = an.staged_patches(*SHAPE, torch.Generator().manual_seed(1), "cpu")
    an.reset_launches()
    with torch.no_grad():
        weights = tfs.pack_weights(step, True, direction == "reverse")
        for variant in TABLES[direction]:
            if direction == "forward":
                got = an.forward_variant(variant, weights, z, patches)
                want = an.forward_variant_ref(variant, weights, z, patches)
            elif direction == "reverse":
                got = (an.reverse_variant(variant, weights, z, patches),)
                want = (an.reverse_variant_ref(variant, weights, z, patches),)
            else:
                g_z, grads = an.backward_variant(variant, weights, z, g_zn, g_ld, patches)
                rz, rgrads = an.backward_variant_ref(variant, weights, z, g_zn, g_ld, patches)
                got, want = (g_z, *grads), (rz, *rgrads)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), variant
        with pytest.raises(ValueError, match="CUDA"):
            if direction == "forward":
                an._launch_forward("full", weights, z, None, None)
            elif direction == "reverse":
                an._launch_reverse("full", weights, z, None, None)
            else:
                an._launch_backward("full", weights, z, g_zn, g_ld, None, None)
    assert not any(an.launches.values())


@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_buffers_must_match_the_launch(direction):
    """A timing loop's reused buffers are checked against the launch's
    shape, since the kernel writes through their pointers."""
    _, step = _pair(4, "affine")
    z = torch.from_numpy(_z(SHAPE))
    weights = tfs.pack_weights(step, True, direction == "reverse")
    bufs = an.make_buffers(direction, weights, z)
    assert an._buffers(direction, weights, z, bufs) is bufs
    with pytest.raises(ValueError, match="buffers made for"):
        an._buffers(direction, weights, z[:1], bufs)


def _global_kernels() -> set[str]:
    """The names of every `__global__` function in the port's CUDA sources."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    csrc = REPO / "pytorch_glow_tpu_torch" / "csrc"
    return {m.group(1) for path in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]
            for m in pattern.finditer(path.read_text())}


@pytest.mark.parametrize("where", ["S1", "S2", "S3", "K6"])
def test_profiled_kernel_names_exist_in_the_sources(where):
    """Every kernel name the timing scripts look for in a profiler trace
    (the anatomy `CHAIN` lists, which `perf_fused_levels --split` reads too,
    and `perf_invconv.K6_KERNELS`) names a `__global__` function of
    `csrc/`, so a renamed launch fails here rather than on the card."""
    from pytorch_glow_tpu_torch.scripts import perf_bwd_anatomy, perf_invconv
    from pytorch_glow_tpu_torch.scripts import perf_kernel_anatomy, perf_reverse_anatomy

    names = {"S1": [n for n, _, _ in perf_kernel_anatomy.CHAIN],
             "S2": [n for n, _, _ in perf_reverse_anatomy.CHAIN],
             "S3": [n for n, _, _ in perf_bwd_anatomy.CHAIN],
             "K6": list(perf_invconv.K6_KERNELS)}[where]
    kernels = _global_kernels()
    assert {"mix_tile_kernel", "coupling_update_kernel", "gemm_kernel"} <= kernels
    missing = [n for alternatives in names for n in alternatives.split("|")
               if n.rsplit("::", 1)[-1] not in kernels]
    assert not missing, f"{where} names kernels that csrc/ does not define: {missing}"


@pytest.mark.cuda
@pytest.mark.parametrize("direction", list(TABLES))
def test_kernels_match_plain_version_on_the_card(direction):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels on one")
    _, step = _pair(12, "affine")
    shape = (4, 16, 16, 12)
    z, g_zn, g_ld = (torch.from_numpy(a).cuda() for a in _inputs(shape))
    patches = an.staged_patches(*shape, torch.Generator().manual_seed(1))
    step = step.cuda()
    with torch.no_grad():
        weights = [t.contiguous() for t in tfs.pack_weights(step, True, direction == "reverse")]
        for variant in TABLES[direction]:
            if direction == "forward":
                got = an.forward_variant(variant, weights, z, patches)
                want = an.forward_variant_ref(variant, weights, z, patches)
            elif direction == "reverse":
                got = (an.reverse_variant(variant, weights, z, patches),)
                want = (an.reverse_variant_ref(variant, weights, z, patches),)
            else:
                g_z, grads = an.backward_variant(variant, weights, z, g_zn, g_ld, patches)
                rz, rgrads = an.backward_variant_ref(variant, weights, z, g_zn, g_ld, patches)
                got, want = (g_z, *grads), (rz, *rgrads)
            for i, (a, b) in enumerate(zip(got, want)):
                scale = max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= 5e-2 * scale, (variant, i)
