"""The fused flow step: weight packing, its plain PyTorch version, the
wrappers that launch the hand-written CUDA kernels, and the autograd
Functions around them.

Counterpart of the non-kernel parts of `pytorch_glow_tpu/ops/flowstep_pallas.py`
(`pack_weights`, `_cross_perm`, `param_logdet`, `step_forward`,
`step_reverse`, `step_backward_t`) and of the custom VJPs in
`pytorch_glow_tpu/models/glow.py` (`_fused_step_forward`,
`_fused_step_reverse`).  `csrc/flowstep.cu` replaces that module's
`_make_kernel` (reverse=False and reverse=True), `csrc/flowstep_bwd.cu` its
`_make_bwd_kernel`, `csrc/flowstep_band.cu` its `_make_kernel_halo` and
`csrc/flowstep_band_bwd.cu` its `_make_bwd_kernel_halo`.  Every chain runs
the coupling net's three products (conv1 on staged patches, conv2 and conv3)
and the backward's six gradient products on one wgmma/TMA GEMM core
(`csrc/gemm_sm90.cuh`), which `gemm_core` exposes alone for checking.  The
core reads rows a multiple of 16 bytes apart: the chains stage conv1's
patches with `padded` columns and read the wrapper's padded copy of w1
(`padded_w1`), so hidden must be a multiple of 8 (`supported`).

Layout: the port keeps NHWC at its public functions, which is already
pixel-major; the kernels take the (B*H*W, C) view of it.

Tiling (`tiling`): the kernel chains stage their intermediates in device
memory and index them in 32 bits.  A call whose whole-batch staging fits
`STAGING_BUDGET_BYTES` and whose indices fit in int32 runs the whole chain
(K1-K3); any other runs the row-band chain (K4/K5), which stages G bands
of R rows at a time, each with the 2-row halo the coupling net's two 3x3
convs see (`band_rows`, `bands_per_launch`).  The TPU kernels cut bands for
VMEM; these rules are the card's own.

`step_forward` / `step_reverse` / `step_backward` pick whole or band by
`tiling()` and the implementation from the tensor's device only: a CPU
tensor runs the plain version (`step_*_ref` or `step_*_band_ref`), a CUDA
tensor launches the kernel chain or raises.  Nothing falls back.

Slab form (spatial sharding, `parallel/spatial.py`): with a `Slab`, the
input z is one rank's row slab of each image with HALO rows of each
neighbouring slab around it, and the step always runs the band chain over
the slab's own rows, R dividing the slab height.  Taps mask on the
absolute image row, so the rows the exchange leaves unfilled at the
image's top and bottom never count.  The outputs are the slab's rows,
its logdet partial and, backward, the padded slab's cotangent: the slab's
rows, and the HALO rows above and below, which belong to the neighbours.
`FusedStep` / `FusedStepReverse` take the slab as their third argument.

The plain version computes the kernel's math, not the layer math of
`models/layers.py`: f32 actnorm and f32 mix; coupling-net operands rounded
to bf16 and multiplied in f32 (exact products, f32 sums, as the JAX
kernel's `_dot_bf16` in interpret mode); the conv actnorms in f32 before
the bf16 cast.  It runs at the coupling dtype of the packed w1 (bf16, or
f32 where a test packs f32 weights to check the algebra).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pytorch_glow_tpu_torch.ops import _build

COUPLING_DTYPE = torch.bfloat16
N_WEIGHTS = 12
# The tiling chooser's knobs, module-level so that tests can patch them.
STAGING_BUDGET_BYTES = 2**30  # device staging one chain launch may take
BAND_PIXELS = 4096  # centre pixels of one band, at most
HALO = 2  # rows a band stages above and below its own (the net's two 3x3 convs)


@dataclass(frozen=True)
class Slab:
    """Where a row slab lies in its image: its first row (`origin`) and
    the image's height (`image_rows`).  A slab-form step takes the slab
    padded with HALO rows of each neighbour."""

    origin: int
    image_rows: int

# Kernel launches per chain; one per flow step launched on the card.  The
# band chain's launches in slab form (spatial sharding) count apart.
launches = {"forward": 0, "reverse": 0, "backward": 0,
            "band_forward": 0, "band_reverse": 0, "band_backward": 0,
            "slab_forward": 0, "slab_reverse": 0, "slab_backward": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _cross_perm(rows: torch.Tensor, affine: bool) -> torch.Tensor:
    """Reorder the conv3 output rows from the reference's cross split (shift
    = even, raw = odd channels) into the kernel's contiguous [shift | raw]
    layout.  Slicing, not an index tensor: a host-built index would be a
    blocking host-to-device copy on every call."""
    return torch.cat([rows[0::2], rows[1::2]]) if affine else rows


def pack_weights(step, affine: bool, reverse: bool,
                 coupling_dtype: torch.dtype = COUPLING_DTYPE,
                 gather=None) -> list[torch.Tensor]:
    """One `FlowStep` module -> the 12 kernel operands, in the JAX kernel's
    order, shapes and dtypes (column vectors are (r, 1) f32).  The mix is
    the step's permutation as a (C, C) matrix, whatever its kind (LU or
    plain 1x1 conv, or a fixed permutation's 0/1 matrix).  `gather(t,
    dim)`, where given, makes the full tensor of a tensor-parallel shard
    of conv1 (sharded on its hidden dim 0, its actnorm on dim 1) and conv2
    (on its input dim 1)."""
    conv1, conv2, conv3 = step.f[0], step.f[2], step.f[4]
    w1, b1, l1, w2 = conv1.weight, conv1.actnorm.bias, conv1.actnorm.logs, conv2.weight
    if gather is not None:
        w1, b1, l1, w2 = gather(w1, 0), gather(b1, 1), gather(l1, 1), gather(w2, 1)
    hidden = w1.shape[0]
    cout = conv3.weight.shape[0]
    # (cout, hid, 3, 3) -> rows (tap, cout in [shift | raw] order), cols hid
    w3t = _cross_perm(conv3.weight, affine).permute(2, 3, 0, 1).reshape(9 * cout, hidden)
    # (hid, cin, 3, 3) -> rows hid, cols (tap, cin)
    w1t = w1.permute(0, 2, 3, 1).reshape(hidden, -1)

    def col(v):
        return v.reshape(-1, 1).float()

    return [
        step.permutation.matrix(reverse).float().contiguous(),
        col(step.actnorm.bias),
        col(step.actnorm.logs),
        w1t.to(coupling_dtype),
        col(b1),
        col(l1),
        w2.reshape(hidden, hidden).to(coupling_dtype),
        col(conv2.actnorm.bias),
        col(conv2.actnorm.logs),
        w3t.to(coupling_dtype),
        col(_cross_perm(conv3.bias, affine)),
        col(_cross_perm(conv3.logs.reshape(-1), affine)),
    ]


def param_logdet(step) -> torch.Tensor:
    """Per-pixel logdet of actnorm + permutation for ONE step (the z-free
    terms the kernel does not emit); multiply by H*W outside."""
    return step.actnorm.logs.sum() + step.permutation.logdet()


# ---------------------------------------------------------------------------
# Tiling: the whole-batch chain or row bands
# ---------------------------------------------------------------------------

# The backward workspace's constants: the GEMM core's tile rows, reduction
# slice and target grid (csrc/gemm_sm90.cuh TM, TK, TARGET_BLOCKS), and
# the column-sum chunk (csrc/flowstep_bwd_common.cuh COL_CHUNK).
_TM, _TK, _TARGET_BLOCKS, _COL_CHUNK = 128, 64, 264, 256


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align(nbytes: int) -> int:
    return _ceil(nbytes, 256) * 256


def _cout(c: int, affine: bool) -> int:
    return c if affine else c // 2


def padded(n: int) -> int:
    """Columns of a bf16 buffer the GEMM core reads through TMA: a multiple
    of 8, so its rows lie a multiple of 16 bytes apart
    (csrc/flowstep_bwd_common.cuh `padded`)."""
    return _ceil(n, 8) * 8


def _wgrad_chunk(m: int, n1: int, n2: int) -> int:
    """Pixels per weight-gradient partial (csrc/gemm_sm90.cuh `wgrad_chunk`):
    enough chunks that the core's grid about fills one wave, none under
    16 slices of _TK pixels."""
    tiles = _ceil(n1, _TM) * _ceil(n2, _TM)
    chunks = max(1, min(_TARGET_BLOCKS // tiles, _ceil(m, 16 * _TK)))
    return max(_TK, _ceil(_ceil(m, chunks), _TK) * _TK)


def bwd_workspace_bytes(m: int, c: int, hidden: int, affine: bool) -> int:
    """Bytes of the backward chain's workspace over m staged pixels, as
    `glow_flowstep_bwd_workspace` counts them (csrc/flowstep_bwd_common.cuh
    `carve`): 14 per-pixel intermediates (gy and the conv1 patches p1 with
    padded rows) and the partial sums."""
    ch, cout = c // 2, _cout(c, affine)
    wmax = max(_ceil(m, _wgrad_chunk(m, n1, n2)) * n1 * n2
               for n1, n2 in ((hidden, 9 * ch), (hidden, hidden), (9 * cout, hidden)))
    per_pixel = [4 * c, 2 * hidden, 2 * hidden, 36 * cout, 4 * cout, 4 * cout,
                 2 * padded(9 * cout), 2 * hidden, 2 * hidden, 36 * ch, 4 * c, 4 * c, 4 * c,
                 2 * padded(9 * ch)]
    partials = [4 * hidden * _ceil(m, _TM)] * 4 + [4 * wmax,
                                                  4 * _ceil(m, _COL_CHUNK) * max(c * c, hidden)]
    return sum(_align(m * n) for n in per_pixel) + sum(_align(n) for n in partials)


def _net_bytes(m: int, c: int, hidden: int, affine: bool) -> int:
    """The coupling net's staging over m pixels: conv1's patches p1 (bf16,
    padded rows), h1 and h2 (bf16) and the tap-packed y (f32)."""
    return m * (2 * padded(9 * (c // 2)) + 4 * hidden + 36 * _cout(c, affine))


def _staging_bytes(direction: str, m: int, c: int, hidden: int, affine: bool) -> int:
    """Device staging of one whole-chain launch over m pixels: the net's
    (and the reverse's scratch), or the backward's workspace."""
    if direction == "backward":
        return bwd_workspace_bytes(m, c, hidden, affine)
    return _net_bytes(m, c, hidden, affine) + (4 * m * c if direction == "reverse" else 0)


def _band_staging_bytes(direction: str, g: int, r: int, w: int, c: int, hidden: int,
                        affine: bool) -> int:
    """Device staging of one band-chain launch of g bands of r rows: the
    whole chain's over their g*(r+4)*w staged pixels, plus the staged z
    (and the forward's mixed z, the reverse's centre scratch, the
    backward's staged cotangent and g_z).  The backward's per-band halo
    rows and per-group weight-grad slots, a few MB, are not staging."""
    me = g * (r + 4) * w
    ext = 4 * me * c
    if direction == "backward":
        return bwd_workspace_bytes(me, c, hidden, affine) + 3 * _align(ext)
    nbytes = _net_bytes(me, c, hidden, affine) + ext
    return nbytes + (ext if direction == "forward" else 4 * g * r * w * c)


def _width(c: int, hidden: int, affine: bool) -> int:
    """The widest per-pixel row a chain indexes: h1, y or gy (padded), z."""
    return max(hidden, padded(9 * _cout(c, affine)), c)


def _fits_int32(m: int, c: int, hidden: int, affine: bool) -> bool:
    """The chains index their per-pixel buffers in 32 bits."""
    return m * _width(c, hidden, affine) < 2**31


def band_rows(h: int, w: int) -> int:
    """Band height R: the largest divisor of h with R >= 4 and
    R * w <= BAND_PIXELS; h itself when h * w <= BAND_PIXELS or no divisor
    qualifies."""
    if h * w <= BAND_PIXELS:
        return h
    rows = [r for r in range(4, h) if h % r == 0 and r * w <= BAND_PIXELS]
    return rows[-1] if rows else h


def bands_per_launch(direction: str, b: int, h: int, w: int, c: int, hidden: int,
                     affine: bool = True) -> int:
    """G: how many (R+4)-row extended bands one band-chain launch stages
    within STAGING_BUDGET_BYTES and 32-bit indexing (at least one)."""
    r = band_rows(h, w)
    index_cap = (2**31 - 1) // ((r + 4) * w * _width(c, hidden, affine))
    lo, hi = 1, max(1, min(b * (h // r), index_cap))
    while lo < hi:  # the largest g whose staging fits (staging grows with g)
        mid = (lo + hi + 1) // 2
        if _band_staging_bytes(direction, mid, r, w, c, hidden, affine) <= STAGING_BUDGET_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


def tiling(direction: str, b: int, h: int, w: int, c: int, hidden: int,
           affine: bool = True) -> str:
    """"whole" when the whole-batch chain's staging fits STAGING_BUDGET_BYTES
    and its indices fit in int32, else "band".  direction: "forward",
    "reverse" or "backward".  Raises for a shape no tiling takes."""
    _require_supported(b, h, w, c, hidden, affine)
    m = b * h * w
    whole = _fits_int32(m, c, hidden, affine)
    if whole and _staging_bytes(direction, m, c, hidden, affine) <= STAGING_BUDGET_BYTES:
        return "whole"
    return "band" if _fits_int32((band_rows(h, w) + 4) * w, c, hidden, affine) else "whole"


def supported(h: int, w: int, c: int, hidden: int, affine: bool = True,
              b: int | None = None) -> bool:
    """Shapes some tiling takes: an even channel count, hidden a multiple of
    8 (the GEMM core's TMA reads h1 and h2 rows a multiple of 16 bytes
    apart), and 32-bit indices over the whole batch or over one extended
    band."""
    if c < 2 or c % 2 or hidden < 8 or hidden % 8 or h < 1 or w < 1:
        return False
    return (_fits_int32((b or 1) * h * w, c, hidden, affine)
            or _fits_int32((band_rows(h, w) + 4) * w, c, hidden, affine))


def _require_supported(b: int, h: int, w: int, c: int, hidden: int, affine: bool) -> None:
    if not supported(h, w, c, hidden, affine, b):
        raise NotImplementedError(
            f"no flow-step kernel tiling takes (b={b}, h={h}, w={w}, c={c}, hidden={hidden}): "
            f"it needs an even c, hidden a multiple of 8, and the whole batch or one "
            f"{band_rows(h, w)}-row band with its halo to index in 32 bits")


# ---------------------------------------------------------------------------
# The roofline bound of one chain call
# ---------------------------------------------------------------------------

# Published H100 SXM peaks at 700 W: dense bf16 tensor cores, f32 outside
# them, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(kind: str, b: int, h: int, w: int, c: int, hidden: int,
             affine: bool) -> tuple[float, str]:
    """The least time one flow-step chain call ("forward", "reverse" or
    "backward") could take on the card, and what bounds it ("operations" or
    "bytes"): the larger of its operations over the peak rate of their type
    (the coupling net's bf16 products, the f32 mix) and its compulsory
    bytes (each input read once, each output written once) over the memory
    rate.  The backward recomputes the net and forms two more products per
    layer, as the JAX kernel's cost estimate counts it."""
    m, ch = b * h * w, c // 2
    net_w = hidden * (9 * ch + hidden + 9 * _cout(c, affine))
    vec = c * c + 2 * c + 4 * hidden + 2 * _cout(c, affine)
    net = 2 * m * net_w
    weight_bytes = 4 * vec + 2 * net_w
    if kind == "backward":  # z, g_zn in, g_z out; g_ld in; 12 f32 grads out
        bf16, f32 = 3 * net, 12 * m * c * c
        nbytes = 3 * 4 * m * c + 4 * b + weight_bytes + 4 * (vec + net_w)
    else:  # z in, z_next out, logdet out
        bf16, f32 = net, 2 * m * c * c
        nbytes = 2 * 4 * m * c + 4 * b + weight_bytes
    t_ops = bf16 / PEAK_BF16 + f32 / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors, tests, and the on-card comparison)
# ---------------------------------------------------------------------------


def _taps(x: torch.Tensor) -> list[torch.Tensor]:
    """The 9 SAME-padded 3x3 neighbours of NHWC x, tap k = 3*dy + dx."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]


def _shift_back(x: torch.Tensor, k: int) -> torch.Tensor:
    """The transpose of tap k of `_taps`: out[p] = x[p - off_k], zero where
    p - off_k leaves the image (off_k = (dy - 1, dx - 1))."""
    _, h, w, _ = x.shape
    dy, dx = divmod(k, 3)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w, :]


def _net_parts(z1: torch.Tensor, weights, dtype: torch.dtype, valid: torch.Tensor | None = None):
    """The coupling net f() as the kernel computes it, with its
    intermediates: NHWC z1 (f32) -> (p1, h1, h2, out (B, H, W, cout) f32).
    Conv1 reads the GEMM core's layout: the staged patches and w1 with
    `padded` columns, the pad zero (`stage_patches_ref`, `padded_w1`); p1
    comes back without its pad.  `valid` (B, H) marks the rows inside the
    true image (staged bands): the taps read rows outside it as zero."""
    _, _, _, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    b, h, w, _ = z1.shape
    cout = w3.shape[0] // 9
    rows = None if valid is None else valid[..., None, None]
    p1 = stage_patches_ref(z1, dtype, valid).float()
    a = p1 @ padded_w1(w1).float().T
    a = (a + a1b.view(-1)) * torch.exp(a1l.view(-1))
    h1 = torch.relu(a).to(dtype).float()
    a = h1 @ w2.float().T
    a = (a + a2b.view(-1)) * torch.exp(a2l.view(-1))
    h2 = torch.relu(a).to(dtype).float()
    y = h2 @ w3.float().T  # tap-packed zero-conv: (B, H, W, 9*cout)
    if valid is not None:
        y = torch.where(rows, y, 0.0)
    acc = torch.zeros(b, h, w, cout, dtype=torch.float32, device=z1.device)
    for k, tap in enumerate(_taps(y)):
        acc = acc + tap[..., k * cout:(k + 1) * cout]
    out = (acc + b3.view(-1)) * torch.exp(l3.view(-1) * 3.0)
    return p1[..., :w1.shape[1]], h1, h2, out


def _pad_cols(x: torch.Tensor) -> torch.Tensor:
    """x with its last dimension zero-padded to `padded` columns (x itself
    where it has them)."""
    pad = padded(x.shape[-1]) - x.shape[-1]
    return F.pad(x, (0, pad)) if pad else x


def padded_w1(w1: torch.Tensor) -> torch.Tensor:
    """Conv1's packed weight (hidden, 9*ch) as the GEMM core reads it: rows
    of `padded(9*ch)` columns, the pad zero (at ch = 6 a row of 54 bf16 is
    108 bytes, which TMA cannot stride).  `pack_weights` keeps the JAX
    kernel's (hidden, 9*ch)."""
    return _pad_cols(w1)


def stage_patches_ref(z1: torch.Tensor, dtype: torch.dtype = COUPLING_DTYPE,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the chains' patch staging
    (csrc/flowstep_common.cuh `stage_patches_kernel`): NHWC z1 ->
    conv1's patches (B, H, W, padded(9 * ch)) in `dtype`, tap k = 3*dy + dx
    masked at the image border (and, with `valid`, on rows outside the true
    image), the pad columns zero."""
    z1 = z1.float()
    if valid is not None:
        z1 = torch.where(valid[..., None, None], z1, 0.0)
    return _pad_cols(torch.cat(_taps(z1), dim=-1).to(dtype))


def _net_ref(z1: torch.Tensor, weights, dtype: torch.dtype,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """The coupling net f(): NHWC z1 (f32) -> (B, H, W, cout) f32."""
    return _net_parts(z1, weights, dtype, valid)[3]


def _forward_parts(weights, z: torch.Tensor, affine: bool, dtype: torch.dtype,
                   valid: torch.Tensor | None = None):
    """NHWC z -> (z_next, log_sigmoid(raw + 2) per pixel, or None when
    additive)."""
    wmat, anb, anl = weights[:3]
    ch = z.shape[-1] // 2
    z = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    z = z @ wmat.T
    z1, z2 = z[..., :ch], z[..., ch:]
    h = _net_ref(z1, weights, dtype, valid)
    if not affine:
        return torch.cat([z1, z2 + h], dim=-1), None
    shift, raw = h[..., :ch], h[..., ch:]
    z2 = (z2 + shift) * torch.sigmoid(raw + 2.0)
    return torch.cat([z1, z2], dim=-1), F.logsigmoid(raw + 2.0)


def step_forward_ref(weights, z: torch.Tensor, affine: bool,
                     dtype: torch.dtype = COUPLING_DTYPE):
    """NHWC z -> (z_next, coupling logdet (B,)), the kernel's math in PyTorch."""
    z_next, logsig = _forward_parts(weights, z, affine, dtype)
    if logsig is None:
        return z_next, torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    return z_next, logsig.sum(dim=(1, 2, 3))


def _reverse_coupling(weights, z: torch.Tensor, affine: bool, dtype: torch.dtype,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    ch = z.shape[-1] // 2
    z = z.float()
    z1, z2 = z[..., :ch], z[..., ch:]
    h = _net_ref(z1, weights, dtype, valid)
    if affine:
        shift, raw = h[..., :ch], h[..., ch:]
        z2 = z2 / torch.sigmoid(raw + 2.0) - shift
    else:
        z2 = z2 - h
    return torch.cat([z1, z2], dim=-1)


def _reverse_mix(weights, t: torch.Tensor) -> torch.Tensor:
    """The W^-1 mix and the actnorm inverse, per pixel."""
    wmat, anb, anl = weights[:3]
    return (t @ wmat.T) * torch.exp(-anl.view(-1)) - anb.view(-1)


def step_reverse_ref(weights, z: torch.Tensor, affine: bool,
                     dtype: torch.dtype = COUPLING_DTYPE) -> torch.Tensor:
    """Inverse of `step_forward_ref` (weights packed with reverse=True)."""
    return _reverse_mix(weights, _reverse_coupling(weights, z, affine, dtype))


def step_backward_ref(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                      affine: bool, dtype: torch.dtype = COUPLING_DTYPE,
                      valid: torch.Tensor | None = None):
    """The backward of `step_forward_ref`, written out as the kernel computes
    it (the JAX kernel's `_make_bwd_kernel` math): recompute, then the
    cotangents.  NHWC z, g_zn (cotangent of z_next) and g_ld (B,) ->
    (g_z, [12 f32 weight grads in the packed shapes]).  bf16 roundings at the
    kernel's places: the patches, h1, h2, gy, g_a2 and g_a1.

    For staged bands (`step_backward_band_ref`): `valid` (B, H) marks the
    rows inside the true image, as in `_net_parts`, and g_ld may be given
    per row, (B, H), zero on the halo rows."""
    wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    ch = z.shape[-1] // 2
    rows = None if valid is None else valid[..., None, None]

    def cast(t):
        return t.to(dtype).float()

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def colsum(t):
        return flat(t).sum(0).reshape(-1, 1)

    def in_image(t):  # a transposed tap lands only on rows inside the image
        return t if rows is None else torch.where(rows, t, 0.0)

    u = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    v = u @ wmat.T
    v2 = v[..., ch:]
    _, h1, h2, out = _net_parts(v[..., :ch], weights, dtype, valid)
    g_zn = g_zn.float()
    go1, go2 = g_zn[..., :ch], g_zn[..., ch:]
    if affine:
        shift = out[..., :ch]
        s = torch.sigmoid(out[..., ch:] + 2.0)
        gl = g_ld.float().view(g_ld.shape[0], -1, 1, 1)
        # The saturation-safe form: g_ld * (1 - s) is d log_sigmoid / d raw,
        # finite where s underflows to 0.
        g_raw = go2 * (v2 + shift) * (s * (1.0 - s)) + gl * (1.0 - s)
        g_v2 = go2 * s
        g_out = torch.cat([g_v2, g_raw], dim=-1)
    else:
        g_v2 = g_out = go2
    g_acc = g_out * torch.exp(l3.view(-1) * 3.0)
    gy = cast(in_image(torch.cat([_shift_back(g_acc, k) for k in range(9)], dim=-1)))
    # The six gradient products in the GEMM core's layouts: gy and the
    # staged patches p1 padded to `padded` columns, the transposed weights
    # as the wrapper makes them.
    gy = _pad_cols(gy)
    p1 = stage_patches_ref(v[..., :ch], dtype, valid).float()
    w1t, w2t, w3t = (t.float() for t in transposed_weights(weights))

    g_a2n = (gy @ w3t.T) * (h2 > 0)
    g_a2 = g_a2n * torch.exp(a2l.view(-1))
    g_a2b = cast(g_a2)
    g_a1n = (g_a2b @ w2t.T) * (h1 > 0)
    g_a1 = g_a1n * torch.exp(a1l.view(-1))
    g_a1b = cast(g_a1)
    g_p1 = g_a1b @ w1t.T
    g_v1 = go1
    for k in range(9):
        g_v1 = g_v1 + in_image(_shift_back(g_p1[..., k * ch:(k + 1) * ch], k))
    g_v = torch.cat([g_v1, g_v2], dim=-1)
    g_u = g_v @ wmat
    g_z = g_u * torch.exp(anl.view(-1))
    grads = [
        flat(g_v).T @ flat(u), colsum(g_z), colsum(g_u * u),
        (flat(g_a1b).T @ flat(p1))[:, :9 * ch], colsum(g_a1), colsum(g_a1n * h1),
        flat(g_a2b).T @ flat(h1), colsum(g_a2), colsum(g_a2n * h2),
        (flat(gy).T @ flat(h2))[:w3.shape[0]], colsum(g_acc), 3.0 * colsum(g_out * out),
    ]
    return g_z, grads


# ---------------------------------------------------------------------------
# Plain band versions: the kernels' row-band math in PyTorch
# ---------------------------------------------------------------------------


def _band_plan(direction: str, z: torch.Tensor, hidden: int, affine: bool,
               slab: Slab | None = None):
    """(R, T bands per image, G bands per group, number of bands) for z (in
    slab form, for its centre rows)."""
    b, h, w, c = z.shape
    if slab is not None:
        h -= 2 * HALO
    r = band_rows(h, w)
    return r, h // r, bands_per_launch(direction, b, h, w, c, hidden, affine), b * (h // r)


def _band_regions(x: torch.Tensor, r: int, first: int, count: int, slab: Slab | None = None):
    """Bands first .. first+count-1 of NHWC x, each with its 2 rows above and
    below: ((count, r+4, W, C) f32 with rows outside the image zero, the
    rows' in-image mask (count, r+4)).  With a slab, x is the slab padded
    with HALO rows of each neighbour and the mask is on the image's rows."""
    lead = 0 if slab is None else HALO
    h = x.shape[1] - 2 * lead
    origin, image = (0, h) if slab is None else (slab.origin, slab.image_rows)
    t = h // r
    bands = torch.arange(first, first + count, device=x.device)
    rel = ((bands % t) * r - 2)[:, None] + torch.arange(r + 4, device=x.device)
    valid = (rel + origin >= 0) & (rel + origin < image)
    ext = x.float()[(bands // t)[:, None], (rel + lead).clamp(0, x.shape[1] - 1)]
    return torch.where(valid[..., None, None], ext, 0.0), valid


def step_forward_band_ref(weights, z: torch.Tensor, affine: bool,
                          dtype: torch.dtype = COUPLING_DTYPE, slab: Slab | None = None):
    """`step_forward_ref` over row bands, as K4 computes it: each group of
    bands staged with its halo (rows outside the image zero, taps masked on
    absolute rows), the step run on the staged rows, the centre rows kept;
    logdet over centre rows, each image's bands summed in band order.  With
    a slab, z is the padded slab and the outputs are the slab's rows and
    its logdet partial."""
    b, _, w, c = z.shape
    r, t, g, nbands = _band_plan("forward", z, weights[3].shape[0], affine, slab)
    out = torch.empty(nbands, r, w, c, dtype=torch.float32, device=z.device)
    parts = []
    for first in range(0, nbands, g):
        count = min(g, nbands - first)
        ext, valid = _band_regions(z, r, first, count, slab)
        z_next, logsig = _forward_parts(weights, ext, affine, dtype, valid)
        out[first:first + count] = z_next[:, 2:r + 2]
        if logsig is not None:
            parts.append(logsig[:, 2:r + 2].sum(dim=(1, 2, 3)))
    ld = torch.zeros(b, dtype=torch.float32, device=z.device)
    if parts:
        per_band = torch.cat(parts).view(b, t)
        for i in range(t):
            ld = ld + per_band[:, i]
    return out.view(b, t * r, w, c), ld


def step_reverse_band_ref(weights, z: torch.Tensor, affine: bool,
                          dtype: torch.dtype = COUPLING_DTYPE,
                          slab: Slab | None = None) -> torch.Tensor:
    """`step_reverse_ref` over row bands, as K4's reverse computes it: f()
    on the staged input bands, the coupling inverse, the W^-1 mix and the
    actnorm inverse on the centre rows (the slab's rows, with a slab)."""
    b, _, w, c = z.shape
    r, t, g, nbands = _band_plan("reverse", z, weights[3].shape[0], affine, slab)
    out = torch.empty(nbands, r, w, c, dtype=torch.float32, device=z.device)
    for first in range(0, nbands, g):
        count = min(g, nbands - first)
        ext, valid = _band_regions(z, r, first, count, slab)
        coupled = _reverse_coupling(weights, ext, affine, dtype, valid)
        out[first:first + count] = _reverse_mix(weights, coupled[:, 2:r + 2])
    return out.view(b, t * r, w, c)


def step_backward_band_ref(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                           affine: bool, dtype: torch.dtype = COUPLING_DTYPE,
                           slab: Slab | None = None):
    """`step_backward_ref` over row bands, as K5 computes it: per group of
    bands, the backward on the staged rows with the output cotangent zero on
    the halo rows (those outputs belong to the neighbouring bands) and g_ld
    on the centre rows only; each band's g_z keeps its centre rows, and its
    2 top and 2 bottom halo rows fold into the neighbouring bands of the
    same image; the weight grads are summed over groups in group order.

    With a slab, z is the padded slab and g_zn the slab's rows: g_z is the
    padded slab's cotangent, its HALO rows above and below the slab's own
    outer halo rows (the first band's top, the last band's bottom), which
    belong to the neighbouring slabs; the weight grads are the slab's
    partials."""
    b, _, w, c = z.shape
    r, t, g, nbands = _band_plan("backward", z, weights[3].shape[0], affine, slab)
    dev = z.device
    g_z = torch.empty(nbands, r, w, c, dtype=torch.float32, device=dev)
    tops = torch.empty(nbands, 2, w, c, dtype=torch.float32, device=dev)
    bottoms = torch.empty_like(tops)
    centre = torch.zeros(r + 4, dtype=torch.bool, device=dev)
    centre[2:r + 2] = True
    grads = None
    for first in range(0, nbands, g):
        count = min(g, nbands - first)
        ext, valid = _band_regions(z, r, first, count, slab)
        g_ext = torch.where(centre[:, None, None], _band_regions(g_zn, r, first, count)[0], 0.0)
        bands = torch.arange(first, first + count, device=dev)
        g_ld_rows = torch.where(centre, g_ld.float()[bands // t][:, None], 0.0)
        g_ext_z, part = step_backward_ref(weights, ext, g_ext, g_ld_rows, affine, dtype, valid)
        g_z[first:first + count] = g_ext_z[:, 2:r + 2]
        tops[first:first + count] = g_ext_z[:, :2]
        bottoms[first:first + count] = g_ext_z[:, r + 2:]
        grads = part if grads is None else [a + p for a, p in zip(grads, part)]
    g_z = g_z.view(b, t, r, w, c)
    g_z[:, 1:, :2] += bottoms.view(b, t, 2, w, c)[:, :-1]
    g_z[:, :-1, r - 2:] += tops.view(b, t, 2, w, c)[:, 1:]
    g_z = g_z.view(b, t * r, w, c)
    if slab is not None:
        g_z = torch.cat([tops.view(b, t, 2, w, c)[:, 0], g_z,
                         bottoms.view(b, t, 2, w, c)[:, -1]], dim=1)
    return g_z, grads


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(weights, z: torch.Tensor, affine: bool) -> tuple[int, int]:
    if z.device.type != "cuda":
        raise ValueError(f"the flow-step kernel takes CUDA tensors, got {z.device}")
    if z.dtype != torch.float32 or z.dim() != 4:
        raise ValueError(f"z must be (B, H, W, C) float32, got {tuple(z.shape)} {z.dtype}")
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} packed weights, got {len(weights)}")
    b, h, w, c = z.shape
    hidden = weights[3].shape[0]
    ch = c // 2
    cout = c if affine else ch
    expect = [
        ((c, c), torch.float32), ((c, 1), torch.float32), ((c, 1), torch.float32),
        ((hidden, 9 * ch), torch.bfloat16), ((hidden, 1), torch.float32),
        ((hidden, 1), torch.float32), ((hidden, hidden), torch.bfloat16),
        ((hidden, 1), torch.float32), ((hidden, 1), torch.float32),
        ((9 * cout, hidden), torch.bfloat16), ((cout, 1), torch.float32),
        ((cout, 1), torch.float32),
    ]
    for i, (wt, (shape, dtype)) in enumerate(zip(weights, expect)):
        if tuple(wt.shape) != shape or wt.dtype != dtype or wt.device != z.device:
            raise ValueError(
                f"packed weight {i}: expected {shape} {dtype} on {z.device}, "
                f"got {tuple(wt.shape)} {wt.dtype} on {wt.device}"
            )
        if not wt.is_contiguous():
            raise ValueError(f"packed weight {i} is not contiguous")
    _require_supported(b, h, w, c, hidden, affine)
    return hidden, cout


def _kernel_weights(weights) -> list[torch.Tensor]:
    """The 12 packed weights as the C entries take them: w1 padded
    (`padded_w1`)."""
    return [*weights[:3], padded_w1(weights[3]), *weights[4:]]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(weights, z: torch.Tensor, affine: bool, reverse: bool):
    hidden, cout = _check_operands(weights, z, affine)
    lib = _build.library()
    b, h, w, c = z.shape
    m = b * h * w
    z = z.contiguous()
    dev = z.device
    out = torch.empty_like(z)
    ld = torch.empty(b, dtype=torch.float32, device=dev)
    p1 = torch.empty(m, padded(9 * (c // 2)), dtype=torch.bfloat16, device=dev)
    h1 = torch.empty(m, hidden, dtype=torch.bfloat16, device=dev)
    h2 = torch.empty(m, hidden, dtype=torch.bfloat16, device=dev)
    y = torch.empty(m, 9 * cout, dtype=torch.float32, device=dev)
    tmp = torch.empty_like(z) if reverse else out
    with torch.cuda.device(dev):
        status = lib.glow_flowstep(
            int(reverse), int(affine), b, h, w, c, hidden,
            z.data_ptr(), *(wt.data_ptr() for wt in _kernel_weights(weights)),
            out.data_ptr(), ld.data_ptr(), p1.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            y.data_ptr(), tmp.data_ptr(), _stream(dev),
        )
    _build.check(lib, status, "glow_flowstep")
    launches["reverse" if reverse else "forward"] += 1
    return out, ld


def _slab_geometry(z: torch.Tensor, slab: Slab | None) -> tuple[int, int, int, int]:
    """(centre rows per image, lead rows, origin, image rows) of a band
    chain's input, as the C entries take them."""
    if slab is None:
        return z.shape[1], 0, 0, z.shape[1]
    h = z.shape[1] - 2 * HALO
    if h < 1 or slab.origin < 0 or slab.origin + h > slab.image_rows:
        raise ValueError(f"a slab of {h} rows at row {slab.origin} does not fit an image of "
                         f"{slab.image_rows} rows")
    return h, HALO, slab.origin, slab.image_rows


def _launch_band(weights, z: torch.Tensor, affine: bool, reverse: bool,
                 slab: Slab | None = None):
    """K4: the step over row bands, G bands staged per group; in slab form
    over the padded slab's own rows."""
    hidden, cout = _check_operands(weights, z, affine)
    lib = _build.library()
    b, _, w, c = z.shape
    h, lead, origin, image = _slab_geometry(z, slab)
    direction = "reverse" if reverse else "forward"
    r = band_rows(h, w)
    g = bands_per_launch(direction, b, h, w, c, hidden, affine)
    me = g * (r + 4) * w
    z = z.contiguous()
    dev = z.device

    def scratch(rows, cols, dtype=torch.float32):
        return torch.empty(rows, cols, dtype=dtype, device=dev)

    out = torch.empty(b, h, w, c, dtype=torch.float32, device=dev)
    ld = torch.empty(b, dtype=torch.float32, device=dev)
    zext = scratch(me, c)
    v = zext if reverse else scratch(me, c)
    p1 = scratch(me, padded(9 * (c // 2)), torch.bfloat16)
    h1, h2 = scratch(me, hidden, torch.bfloat16), scratch(me, hidden, torch.bfloat16)
    y = scratch(me, 9 * cout)
    tmp = scratch(g * r * w, c) if reverse else out
    ld_band = torch.empty(b * (h // r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.glow_flowstep_band(
            int(reverse), int(affine), b, h, w, c, hidden, r, g, lead, origin, image,
            z.data_ptr(), *(wt.data_ptr() for wt in _kernel_weights(weights)),
            out.data_ptr(), ld.data_ptr(), zext.data_ptr(), v.data_ptr(), p1.data_ptr(),
            h1.data_ptr(), h2.data_ptr(), y.data_ptr(), tmp.data_ptr(), ld_band.data_ptr(),
            _stream(dev),
        )
    _build.check(lib, status, "glow_flowstep_band")
    launches[("band_" if slab is None else "slab_") + direction] += 1
    return out, ld


def transposed_weights(weights) -> list[torch.Tensor]:
    """The backward chain's bf16 transposes of w1, w2 and w3: w1t (9*ch,
    hidden), w2t (hidden, hidden) and w3t (hidden, padded(9*cout)) with zero
    pad columns, the GEMM core's K-major B operands."""
    w3 = weights[9]
    w3t = torch.zeros(w3.shape[1], padded(w3.shape[0]), dtype=w3.dtype, device=w3.device)
    w3t[:, :w3.shape[0]] = w3.t()
    return [weights[3].t().contiguous(), weights[6].t().contiguous(), w3t]


def _backward_operands(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                       affine: bool, slab: Slab | None = None):
    """Checked, contiguous backward operands, the bf16 transposes of w1, w2,
    w3 and the outputs: (hidden, z, g_zn, g_ld, transposed, g_z, grads);
    in slab form g_zn and g_z hold the slab's own rows."""
    hidden, _ = _check_operands(weights, z, affine)
    b, _, w, c = z.shape
    h = _slab_geometry(z, slab)[0]
    if g_zn.shape != (b, h, w, c) or g_ld.shape != (b,):
        raise ValueError(f"cotangents {tuple(g_zn.shape)}, {tuple(g_ld.shape)} do not match "
                         f"z {tuple(z.shape)}")
    if g_zn.device != z.device or g_ld.device != z.device:
        raise ValueError("the cotangents must lie on z's device")
    z = z.contiguous()
    grads = [torch.empty(wt.shape, dtype=torch.float32, device=z.device) for wt in weights]
    return (hidden, z, g_zn.float().contiguous(), g_ld.float().contiguous(),
            transposed_weights(weights),
            torch.empty(g_zn.shape, dtype=torch.float32, device=z.device), grads)


def _launch_backward(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                     affine: bool):
    hidden, z, g_zn, g_ld, transposed, g_z, grads = _backward_operands(
        weights, z, g_zn, g_ld, affine)
    lib = _build.library()
    b, h, w, c = z.shape
    dev = z.device
    nbytes = lib.glow_flowstep_bwd_workspace(int(affine), b, h, w, c, hidden)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        status = lib.glow_flowstep_bwd(
            int(affine), b, h, w, c, hidden,
            z.data_ptr(), *(wt.data_ptr() for wt in _kernel_weights(weights)),
            *(wt.data_ptr() for wt in transposed), g_zn.data_ptr(), g_ld.data_ptr(),
            g_z.data_ptr(), *(g.data_ptr() for g in grads), workspace.data_ptr(), _stream(dev),
        )
    _build.check(lib, status, "glow_flowstep_bwd")
    launches["backward"] += 1
    return g_z, grads


def _launch_band_backward(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                          affine: bool, slab: Slab | None = None):
    """K5: the backward over row bands, G bands staged per group; in slab
    form g_z is the padded slab's cotangent (the outer halo rows' from the
    entry's halo buffers)."""
    hidden, z, g_zn, g_ld, transposed, g_z, grads = _backward_operands(
        weights, z, g_zn, g_ld, affine, slab)
    lib = _build.library()
    b, _, w, c = z.shape
    h, lead, origin, image = _slab_geometry(z, slab)
    dev = z.device
    r = band_rows(h, w)
    g = bands_per_launch("backward", b, h, w, c, hidden, affine)
    nbytes = lib.glow_flowstep_band_bwd_workspace(int(affine), b, h, w, c, hidden, r, g)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    halos = [torch.empty(b, lead, w, c, dtype=torch.float32, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        status = lib.glow_flowstep_band_bwd(
            int(affine), b, h, w, c, hidden, r, g, lead, origin, image,
            z.data_ptr(), *(wt.data_ptr() for wt in _kernel_weights(weights)),
            *(wt.data_ptr() for wt in transposed), g_zn.data_ptr(), g_ld.data_ptr(),
            g_z.data_ptr(), *(gr.data_ptr() for gr in grads),
            *(t.data_ptr() if lead else None for t in halos), workspace.data_ptr(), _stream(dev),
        )
    _build.check(lib, status, "glow_flowstep_band_bwd")
    launches["band_backward" if slab is None else "slab_backward"] += 1
    if slab is not None:
        g_z = torch.cat([halos[0], g_z, halos[1]], dim=1)
    return g_z, grads


def gemm_core_ref(a: torch.Tensor, b: torch.Tensor, trans: bool, m: int, n: int,
                  k: int, actnorm: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """The plain version of the chains' GEMM core (csrc/gemm_sm90.cu
    `glow_gemm_sm90`): the f32 product of two bf16 operands with padded rows.
    trans False: a (m, >= k), b (n, >= k) -> a[:, :k] b[:, :k]^T (the
    coupling net's and the data gradients' order); trans True: a (k, >= m),
    b (k, >= n) -> a[:, :m]^T b[:, :n] (the weight gradients').  With
    `actnorm` = (bias, logs), each (n,) f32 (trans False only), the conv
    epilogue: bf16(relu((product + bias) * e^logs))."""
    if trans:
        return a[:, :m].float().T @ b[:, :n].float()
    out = a[:, :k].float() @ b[:, :k].float().T
    if actnorm is None:
        return out
    bias, logs = (t.reshape(-1).float() for t in actnorm)
    return torch.relu((out + bias) * torch.exp(logs)).to(torch.bfloat16)


def gemm_core(a: torch.Tensor, b: torch.Tensor, trans: bool, m: int, n: int,
              k: int, actnorm: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """The GEMM core alone, as `gemm_core_ref` computes it: the plain
    version for CPU tensors, the wgmma/TMA kernel for CUDA tensors (rows a
    multiple of 8 columns long; with `actnorm`, n a multiple of 8), or
    raises."""
    if a.device.type == "cpu":
        return gemm_core_ref(a, b, trans, m, n, k, actnorm)
    want = ((k, m), (k, n)) if trans else ((m, k), (n, k))
    for name, t, (rows, cols) in (("a", a, want[0]), ("b", b, want[1])):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16 or t.dim() != 2
                or not t.is_contiguous() or t.shape[0] != rows or t.shape[1] < cols
                or t.shape[1] % 8):
            raise ValueError(f"gemm_core {name}: expected a contiguous bf16 CUDA ({rows}, >= "
                             f"{cols}) tensor with a multiple of 8 columns, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    lib = _build.library()
    if actnorm is not None:
        bias, logs = actnorm
        if trans or n % 8 or any(t.shape != (n,) or t.dtype != torch.float32
                                 or t.device != a.device for t in actnorm):
            raise ValueError(f"gemm_core actnorm: the (m, k) . (n, k)^T order with n a multiple "
                             f"of 8 and (n,) f32 bias and logs on {a.device}")
        out = torch.empty(m, n, dtype=torch.bfloat16, device=a.device)
        with torch.cuda.device(a.device):
            status = lib.glow_gemm_sm90_actnorm_relu(
                m, n, k, a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1], bias.data_ptr(),
                logs.data_ptr(), out.data_ptr(), _stream(a.device))
        _build.check(lib, status, "glow_gemm_sm90_actnorm_relu")
        return out
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    workspace = torch.empty(lib.glow_gemm_sm90_workspace(int(trans), m, n, k), dtype=torch.uint8,
                            device=a.device)
    with torch.cuda.device(a.device):
        status = lib.glow_gemm_sm90(int(trans), m, n, k, a.data_ptr(), a.shape[1], b.data_ptr(),
                                    b.shape[1], out.data_ptr(), workspace.data_ptr(),
                                    _stream(a.device))
    _build.check(lib, status, "glow_gemm_sm90")
    return out


def _band(direction: str, weights, z: torch.Tensor, affine: bool,
          slab: Slab | None = None) -> bool:
    if slab is not None:  # the slab form is the band chain's
        return True
    b, h, w, c = z.shape
    return tiling(direction, b, h, w, c, weights[3].shape[0], affine) == "band"


def step_forward(weights, z: torch.Tensor, affine: bool, slab: Slab | None = None):
    """NHWC z -> (z_next, coupling logdet (B,)); `weights` from
    `pack_weights(..., reverse=False)`.  With a slab, z is the padded slab
    and the results the slab's rows and logdet partial."""
    band = _band("forward", weights, z, affine, slab)
    if z.device.type == "cpu":
        if band:
            return step_forward_band_ref(weights, z, affine, weights[3].dtype, slab)
        return step_forward_ref(weights, z, affine, weights[3].dtype)
    if band:
        return _launch_band(weights, z, affine, False, slab)
    return _launch(weights, z, affine, reverse=False)


def step_reverse(weights, z: torch.Tensor, affine: bool,
                 slab: Slab | None = None) -> torch.Tensor:
    """Inverse step; `weights` from `pack_weights(..., reverse=True)`.  With
    a slab, z is the padded slab and the result the slab's rows."""
    band = _band("reverse", weights, z, affine, slab)
    if z.device.type == "cpu":
        if band:
            return step_reverse_band_ref(weights, z, affine, weights[3].dtype, slab)
        return step_reverse_ref(weights, z, affine, weights[3].dtype)
    if band:
        return _launch_band(weights, z, affine, True, slab)[0]
    return _launch(weights, z, affine, reverse=True)[0]


def step_backward(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                  affine: bool, slab: Slab | None = None):
    """Backward of `step_forward` at input z: (g_z, [12 f32 weight grads]);
    with a slab, g_z is the padded slab's cotangent."""
    band = _band("backward", weights, z, affine, slab)
    if z.device.type == "cpu":
        if band:
            return step_backward_band_ref(weights, z, g_zn, g_ld, affine, weights[3].dtype, slab)
        return step_backward_ref(weights, z, g_zn, g_ld, affine, weights[3].dtype)
    if band:
        return _launch_band_backward(weights, z, g_zn, g_ld, affine, slab)
    return _launch_backward(weights, z, g_zn, g_ld, affine)


# ---------------------------------------------------------------------------
# Autograd around the kernels
# ---------------------------------------------------------------------------


class FusedStep(torch.autograd.Function):
    """(z, affine, slab, *packed) -> (z_next, logdet): the forward kernel,
    and a backward that recomputes the step inside the backward kernel from
    the saved input, as the JAX package's custom VJP does.  Weight grads
    come back in the packed dtypes (bf16 for w1, w2, w3, as the JAX package
    rounds them); `pack_weights`' own autograd maps them to the parameters.
    With a `Slab` (None for whole images), z is the padded slab, the
    results the slab's rows and logdet partial (K4 / K5 in slab form), and
    the backward returns the padded slab's cotangent, whose halo rows the
    halo exchange (`parallel/spatial.py`) sends back to their owners.
    Under `torch.no_grad()` apply records no graph and keeps no residuals."""

    @staticmethod
    def forward(ctx, z, affine, slab, *weights):
        ctx.affine, ctx.slab = affine, slab
        ctx.save_for_backward(z, *weights)
        return step_forward(weights, z, affine, slab)

    @staticmethod
    def backward(ctx, g_zn, g_ld):
        z, *weights = ctx.saved_tensors
        g_z, grads = step_backward(weights, z, g_zn, g_ld, ctx.affine, ctx.slab)
        return (g_z, None, None, *(g.to(wt.dtype) for g, wt in zip(grads, weights)))


class FusedStepReverse(torch.autograd.Function):
    """(z, affine, slab, *packed reverse) -> z_prev: the reverse kernel
    (with a `Slab`, over the padded slab, giving the slab's rows), and
    autograd over the plain version for the backward (sampling is not
    trained through, so no kernel; the JAX package differentiates its XLA
    math there too)."""

    @staticmethod
    def forward(ctx, z, affine, slab, *weights):
        ctx.affine, ctx.slab = affine, slab
        ctx.save_for_backward(z, *weights)
        return step_reverse(weights, z, affine, slab)

    @staticmethod
    def backward(ctx, g):
        z, *weights = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            if ctx.slab is None:
                out = step_reverse_ref(weights, z, ctx.affine, weights[3].dtype)
            else:
                out = step_reverse_band_ref(weights, z, ctx.affine, weights[3].dtype, ctx.slab)
            grads = torch.autograd.grad(out, [z, *weights], g)
        return (grads[0], None, None, *grads[1:])
