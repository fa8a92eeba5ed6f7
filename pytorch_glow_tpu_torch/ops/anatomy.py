"""The flow-step anatomy studies S1-S3: variants of the forward (K1),
reverse (K2) and backward (K3) chains that drop one class of work or swap
in an equivalent formula, their plain PyTorch versions, and the wrappers
that launch `csrc/anatomy.cu`.

Counterpart of the variant kernels (`_make_variant`) of the JAX package's
`scripts/perf_kernel_anatomy.py` (S1), `scripts/perf_reverse_anatomy.py`
(S2) and `scripts/perf_bwd_anatomy.py` (S3); the timing scripts are
`pytorch_glow_tpu_torch/scripts/perf_*_anatomy.py`.  Every variant is
affine and runs the whole batch in one chain (no row bands).

A 3x3 tap of pixel m reads its neighbour at flattened offset
off_k = (dy - 1) * W + (dx - 1) in one of four ways (`csrc/flowstep_common.cuh`
`Tap`): "masked" (production: zero where the neighbour leaves the image),
"wrap" (pixel (m + off_k) mod M, no border test: the TPU's lane roll over
one tile, unmasked), "centre" (pixel m) and "centre_masked" (pixel m, zero
where the neighbour leaves the image).  Conv1 reads its patches staged
(`csrc/flowstep_common.cuh` `stage_patches_kernel`) with the variant's
taps; `matmul_only` instead feeds it a given dense patch tensor, `patches`
(B, H, W, padded(9 * C/2)), which the caller makes (`staged_patches`): the
JAX variant reads a scratch it never writes, so the port gives it data.  In
the backward, the gW1 product reads the patches the recompute staged, or
for `matmul_only` patches the chain stages from v with centre taps.

S3's `no_accum` is the JAX variant's: every batch tile of the JAX backward
(`bwd_tile_batch`, a copy of `flowstep_pallas._bwd_tile_batch`) overwrites
the weight grads, so they hold the last tile's contribution alone.  On the
card every chunking of the chain's partial sums is cut where that tile
starts, every chunk is computed as in production, and each reduction sums
the tile's partials only: what the variant drops is the cross-chunk
reduction, as the TPU study dropped the accumulation over its grid.

`forward_variant` / `reverse_variant` / `backward_variant` take the plain
version for a CPU tensor and launch the kernel chain for a CUDA tensor, or
raise.  Nothing falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_glow_tpu_torch.ops import _build
from pytorch_glow_tpu_torch.ops import flowstep as fs

# variant: (conv1 taps, None for the staged patches; zero-conv taps; logdet)
FORWARD = {
    "full": ("masked", "masked", True),
    "no_logdet": ("masked", "masked", False),
    "no_masks": ("wrap", "wrap", True),
    "no_rolls": ("centre", "centre_masked", True),
    "matmul_only": (None, "centre", True),
}
# variant: (zero-conv taps, staged patches, z2 update, mix)
REVERSE = {
    "full": ("masked", False, "div", "mix"),
    "recip_exp": ("masked", False, "recip_exp", "mix"),
    "split_mix": ("masked", False, "div", "split"),
    "no_div": ("masked", False, "mul", "mix"),
    "no_mix": ("masked", False, "div", None),
    "matmul_only": ("centre", True, "div", "mix"),
}
# variant: (taps of every 3x3 read, staged conv1 patches, accumulate over
# the batch tiles, bias/logs sums, weight grads)
BACKWARD = {
    "full": ("masked", False, True, True, True),
    "no_accum": ("masked", False, False, True, True),
    "no_rowsum": ("masked", False, True, False, True),
    "no_wgrad": ("masked", False, True, True, False),
    "no_masks": ("wrap", False, True, True, True),
    "no_rolls": ("centre", False, True, True, True),
    "matmul_only": ("centre", True, True, True, True),
}
# The grads the bias/logs sums give (no_rowsum leaves them 0).
ROWSUM_GRADS = (1, 2, 4, 5, 7, 8, 10, 11)

# Kernel launches per direction, one per anatomy chain launched on the card.
launches = {"anatomy_forward": 0, "anatomy_reverse": 0, "anatomy_backward": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def staged_patches(b: int, h: int, w: int, c: int, generator: torch.Generator | None = None,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """A dense conv1 patch operand for `matmul_only`: (b, h, w,
    padded(9 * c/2)) bf16, normal draws from `generator` (a CPU generator)
    in the first 9 * c/2 columns, the pad zero, as the GEMM core reads
    staged patches."""
    p = torch.randn(b, h, w, 9 * (c // 2), generator=generator)
    return fs._pad_cols(p.to(fs.COUPLING_DTYPE)).to(device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, tap: str) -> list[torch.Tensor]:
    """The 9 taps of NHWC x, tap k = 3*dy + dx, read as `tap` says."""
    if tap == "masked":
        return fs._taps(x)
    if tap == "centre":
        return [x] * 9
    if tap == "centre_masked":
        return [x * m for m in fs._taps(torch.ones_like(x[..., :1]))]
    b, h, w, c = x.shape
    flat = x.reshape(-1, c)
    return [torch.roll(flat, -((dy - 1) * w + dx - 1), 0).view(b, h, w, c)
            for dy in range(3) for dx in range(3)]


def _scatter(x: torch.Tensor, k: int, tap: str) -> torch.Tensor:
    """The transpose of tap k of `_gather`: out[p] = x[p - off_k] ("masked":
    zero where p - off_k leaves the image; "wrap": mod M; "centre": x)."""
    if tap == "masked":
        return fs._shift_back(x, k)
    if tap == "centre":
        return x
    b, h, w, c = x.shape
    dy, dx = divmod(k, 3)
    return torch.roll(x.reshape(-1, c), (dy - 1) * w + dx - 1, 0).view(b, h, w, c)


def _net_parts(z1: torch.Tensor, weights, dtype: torch.dtype, conv1_tap: str | None,
               conv3_tap: str, patches: torch.Tensor | None):
    """The coupling net f() as `fs._net_parts` computes it, its conv1 taps
    read as `conv1_tap` says (None: `patches` as they are), its zero-conv
    taps as `conv3_tap` says: NHWC z1 -> (p1 with padded columns, h1, h2,
    out (B, H, W, cout))."""
    _, _, _, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    b, h, w, _ = z1.shape
    cout = w3.shape[0] // 9
    z1 = z1.float()
    if conv1_tap is not None:
        p1 = fs._pad_cols(torch.cat(_gather(z1, conv1_tap), dim=-1).to(dtype)).float()
    elif patches is None:
        raise ValueError("matmul_only reads staged patches (`staged_patches`); none given")
    else:
        p1 = patches.to(dtype).float()
    a = p1 @ fs.padded_w1(w1).float().T
    a = (a + a1b.view(-1)) * torch.exp(a1l.view(-1))
    h1 = torch.relu(a).to(dtype).float()
    a = h1 @ w2.float().T
    a = (a + a2b.view(-1)) * torch.exp(a2l.view(-1))
    h2 = torch.relu(a).to(dtype).float()
    y = h2 @ w3.float().T  # tap-packed zero-conv: (B, H, W, 9*cout)
    acc = torch.zeros(b, h, w, cout, dtype=torch.float32, device=z1.device)
    for k, tap in enumerate(_gather(y, conv3_tap)):
        acc = acc + tap[..., k * cout:(k + 1) * cout]
    return p1, h1, h2, (acc + b3.view(-1)) * torch.exp(l3.view(-1) * 3.0)


def forward_variant_ref(variant: str, weights, z: torch.Tensor,
                        patches: torch.Tensor | None = None,
                        dtype: torch.dtype = fs.COUPLING_DTYPE):
    """S1's variant of `fs.step_forward_ref` (affine): NHWC z -> (z_next,
    coupling logdet (B,), zero for no_logdet)."""
    conv1, conv3, logdet = FORWARD[variant]
    wmat, anb, anl = weights[:3]
    ch = z.shape[-1] // 2
    v = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    v = v @ wmat.T
    z1, z2 = v[..., :ch], v[..., ch:]
    h = _net_parts(z1, weights, dtype, conv1, conv3, patches)[3]
    shift, raw = h[..., :ch], h[..., ch:]
    z2 = (z2 + shift) * torch.sigmoid(raw + 2.0)
    if logdet:
        ld = F.logsigmoid(raw + 2.0).sum(dim=(1, 2, 3))
    else:
        ld = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    return torch.cat([z1, z2], dim=-1), ld


def reverse_variant_ref(variant: str, weights, z: torch.Tensor,
                        patches: torch.Tensor | None = None,
                        dtype: torch.dtype = fs.COUPLING_DTYPE) -> torch.Tensor:
    """S2's variant of `fs.step_reverse_ref` (affine; weights packed with
    reverse=True)."""
    conv3, staged, update, mix = REVERSE[variant]
    ch = z.shape[-1] // 2
    z = z.float()
    z1, z2 = z[..., :ch], z[..., ch:]
    h = _net_parts(z1, weights, dtype, None if staged else "masked", conv3, patches)[3]
    shift, raw = h[..., :ch], h[..., ch:]
    if update == "div":
        z2 = z2 / torch.sigmoid(raw + 2.0) - shift
    elif update == "recip_exp":
        z2 = z2 * (1.0 + torch.exp(-(raw + 2.0))) - shift
    else:
        z2 = z2 * torch.sigmoid(raw + 2.0) - shift
    if mix is None:
        return torch.cat([z1, z2], dim=-1)
    if mix == "split":
        wmat, anb, anl = weights[:3]
        t = z1 @ wmat[:, :ch].T + z2 @ wmat[:, ch:].T
        return t * torch.exp(-anl.view(-1)) - anb.view(-1)
    return fs._reverse_mix(weights, torch.cat([z1, z2], dim=-1))


# The JAX backward's batch tile (`pytorch_glow_tpu/ops/flowstep_pallas.py`
# `_bwd_tile_batch` and what it reads), copied: no_accum keeps the last
# tile's weight grads, as the JAX variant does.
MAX_TILE_COLS = 4096
_BWD_TOTAL_VMEM = 13 * 2**20


def _bwd_bytes_per_col(c: int, hidden: int) -> int:
    ch = c // 2
    return (2 * hidden * 4 + 2 * hidden * 2 + 9 * ch * 2 + 9 * ch * 4 + 9 * c * 2 + 3 * c * 4
            + 2 * (3 * c + 1) * 4 * 2)


def _bwd_fixed_bytes(c: int, hidden: int, affine: bool = True) -> int:
    ch = c // 2
    cout = c if affine else ch
    w1, w2, w3 = hidden * 9 * ch, hidden * hidden, 9 * cout * hidden
    return (w1 + w2 + w3) * (2 + 4) + 2 * c * c * 4 + 24 * max(c, hidden) * 4


def _bwd_max_cols(c: int, hidden: int, affine: bool = True) -> int:
    budget = _BWD_TOTAL_VMEM - _bwd_fixed_bytes(c, hidden, affine)
    if budget <= 0:
        return 0
    return min(MAX_TILE_COLS, budget // _bwd_bytes_per_col(c, hidden))


def bwd_tile_batch(b: int, h: int, w: int, c: int, hidden: int, affine: bool = True) -> int:
    """Images per batch tile of the JAX backward at this shape: the divisor
    d of b whose d*h*w columns are a multiple of 128 and nearest its column
    cap, else b."""
    hw = h * w
    cap = _bwd_max_cols(c, hidden, affine)
    best = None
    for d in range(1, b + 1):
        if b % d:
            continue
        if (d * hw) % 128 == 0 and d * hw <= cap:
            if best is None or abs(d * hw - cap) < abs(best * hw - cap):
                best = d
    return best if best is not None else b


def backward_variant_ref(variant: str, weights, z: torch.Tensor, g_zn: torch.Tensor,
                         g_ld: torch.Tensor, patches: torch.Tensor | None = None,
                         dtype: torch.dtype = fs.COUPLING_DTYPE):
    """S3's variant of `fs.step_backward_ref` (affine): NHWC z, g_zn and
    g_ld (B,) -> (g_z, [12 f32 weight grads]).  no_accum's grads are the
    last batch tile's alone (`bwd_tile_batch` images); no_rowsum's 8
    bias/logs grads and no_wgrad's 12 grads are zero.  The gW1 product reads
    conv1's patches as the staging kernel writes them, with the variant's
    taps (matmul_only: centre), whatever conv1 read."""
    tap, staged, accum, rowsum, wgrad = BACKWARD[variant]
    wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    b, h, w, c = z.shape
    ch = c // 2

    def cast(t):
        return t.to(dtype).float()

    u = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    v = u @ wmat.T
    v2 = v[..., ch:]
    _, h1, h2, out = _net_parts(v[..., :ch], weights, dtype, None if staged else tap, tap,
                                patches)
    g_zn = g_zn.float()
    go1, go2 = g_zn[..., :ch], g_zn[..., ch:]
    shift = out[..., :ch]
    s = torch.sigmoid(out[..., ch:] + 2.0)
    gl = g_ld.float().view(g_ld.shape[0], -1, 1, 1)
    g_raw = go2 * (v2 + shift) * (s * (1.0 - s)) + gl * (1.0 - s)
    g_v2 = go2 * s
    g_out = torch.cat([g_v2, g_raw], dim=-1)
    g_acc = g_out * torch.exp(l3.view(-1) * 3.0)
    gy = fs._pad_cols(cast(torch.cat([_scatter(g_acc, k, tap) for k in range(9)], dim=-1)))
    w1t, w2t, w3t = (t.float() for t in fs.transposed_weights(weights))

    g_a2n = (gy @ w3t.T) * (h2 > 0)
    g_a2 = g_a2n * torch.exp(a2l.view(-1))
    g_a2b = cast(g_a2)
    g_a1n = (g_a2b @ w2t.T) * (h1 > 0)
    g_a1 = g_a1n * torch.exp(a1l.view(-1))
    g_a1b = cast(g_a1)
    g_p1 = g_a1b @ w1t.T
    g_v1 = go1
    for k in range(9):
        g_v1 = g_v1 + _scatter(g_p1[..., k * ch:(k + 1) * ch], k, tap)
    g_v = torch.cat([g_v1, g_v2], dim=-1)
    g_u = g_v @ wmat
    g_z = g_u * torch.exp(anl.view(-1))
    if not wgrad:
        return g_z, [torch.zeros(wt.shape, dtype=torch.float32, device=z.device)
                     for wt in weights]
    p1 = fs._pad_cols(torch.cat(_gather(v[..., :ch].float(), tap), dim=-1).to(dtype)).float()
    first = 0 if accum else (b - bwd_tile_batch(b, h, w, c, w1.shape[0])) * h * w

    def flat(t):
        return t.reshape(-1, t.shape[-1])[first:]

    def colsum(t):
        return flat(t).sum(0).reshape(-1, 1)

    grads = [
        flat(g_v).T @ flat(u), colsum(g_z), colsum(g_u * u),
        (flat(g_a1b).T @ flat(p1))[:, :9 * ch], colsum(g_a1), colsum(g_a1n * h1),
        flat(g_a2b).T @ flat(h1), colsum(g_a2), colsum(g_a2n * h2),
        (flat(gy).T @ flat(h2))[:w3.shape[0]], colsum(g_acc), 3.0 * colsum(g_out * out),
    ]
    if not rowsum:
        for i in ROWSUM_GRADS:
            grads[i] = torch.zeros_like(grads[i])
    return g_z, grads


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(direction: str, variant: str, table: dict, weights, z: torch.Tensor,
           patches: torch.Tensor | None) -> int:
    """Raise on what the anatomy chains do not take; returns hidden."""
    if variant not in table:
        raise ValueError(f"unknown {direction} anatomy variant {variant!r}: {sorted(table)}")
    hidden, _ = fs._check_operands(weights, z, affine=True)
    b, h, w, c = z.shape
    if fs.tiling(direction, b, h, w, c, hidden) != "whole":
        raise NotImplementedError(f"the anatomy chains run whole batches; {tuple(z.shape)} "
                                  "takes row bands")
    if variant == "matmul_only":
        want = (b, h, w, fs.padded(9 * (c // 2)))
        if (patches is None or tuple(patches.shape) != want or patches.dtype != torch.bfloat16
                or patches.device != z.device or not patches.is_contiguous()):
            raise ValueError(f"matmul_only takes contiguous staged patches {want} bf16 on "
                             f"{z.device}")
    return hidden


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _key(direction: str, weights, z: torch.Tensor) -> tuple:
    """What a launch's buffers depend on: they hold the padded copy of w1
    and the backward's the transposes of w1, w2 and w3."""
    key = (direction, tuple(z.shape), weights[3].shape[0], z.device, weights[3].data_ptr())
    if direction == "backward":
        key += tuple(weights[i].data_ptr() for i in (6, 9))
    return key


def make_buffers(direction: str, weights, z: torch.Tensor) -> dict:
    """The outputs and scratch of one anatomy chain launch on z's device,
    to pass to every launch of a timing loop (direction: "forward",
    "reverse" or "backward").  A launch given them returns these tensors,
    overwritten by the next launch."""
    b, h, w, c = z.shape
    m, hidden, dev = b * h * w, weights[3].shape[0], z.device
    key = _key(direction, weights, z)
    kernel_weights = fs._kernel_weights(weights)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    if direction == "backward":
        tile = bwd_tile_batch(b, h, w, c, hidden) * h * w
        nbytes = _build.library().glow_anatomy_bwd_workspace(b, h, w, c, hidden, tile)
        return {"key": key, "weights": kernel_weights,
                "g_z": torch.empty_like(z, dtype=torch.float32),
                "grads": [empty(*wt.shape) for wt in weights],
                "transposed": fs.transposed_weights(weights),
                "workspace": empty(nbytes, dtype=torch.uint8)}
    bufs = {"key": key, "weights": kernel_weights,
            "out": torch.empty_like(z, dtype=torch.float32),
            "p1": empty(m, fs.padded(9 * (c // 2)), dtype=torch.bfloat16),
            "h1": empty(m, hidden, dtype=torch.bfloat16),
            "h2": empty(m, hidden, dtype=torch.bfloat16), "y": empty(m, 9 * c)}
    if direction == "forward":
        bufs["ld"] = empty(b)
    else:
        bufs["tmp"] = empty(m, c)
    return bufs


def _buffers(direction: str, weights, z: torch.Tensor, bufs: dict | None) -> dict:
    """`bufs`, checked to be `make_buffers`' for this launch, or new ones."""
    if bufs is None:
        return make_buffers(direction, weights, z)
    if bufs.get("key") != _key(direction, weights, z):
        raise ValueError(f"buffers made for {bufs.get('key')}, not {_key(direction, weights, z)}")
    return bufs


def _launch_forward(variant: str, weights, z: torch.Tensor, patches, bufs):
    hidden = _check("forward", variant, FORWARD, weights, z, patches)
    lib = _build.library()
    b, h, w, c = z.shape
    z = z.contiguous()
    bufs = _buffers("forward", weights, z, bufs)
    with torch.cuda.device(z.device):
        status = lib.glow_anatomy_forward(
            list(FORWARD).index(variant), b, h, w, c, hidden, z.data_ptr(),
            *(wt.data_ptr() for wt in bufs["weights"]), _ptr(patches), bufs["out"].data_ptr(),
            bufs["ld"].data_ptr(), bufs["p1"].data_ptr(), bufs["h1"].data_ptr(),
            bufs["h2"].data_ptr(), bufs["y"].data_ptr(), fs._stream(z.device))
    _build.check(lib, status, f"glow_anatomy_forward ({variant})")
    launches["anatomy_forward"] += 1
    return bufs["out"], bufs["ld"]


def _launch_reverse(variant: str, weights, z: torch.Tensor, patches, bufs):
    hidden = _check("reverse", variant, REVERSE, weights, z, patches)
    lib = _build.library()
    b, h, w, c = z.shape
    z = z.contiguous()
    bufs = _buffers("reverse", weights, z, bufs)
    with torch.cuda.device(z.device):
        status = lib.glow_anatomy_reverse(
            list(REVERSE).index(variant), b, h, w, c, hidden, z.data_ptr(),
            *(wt.data_ptr() for wt in bufs["weights"]), _ptr(patches), bufs["out"].data_ptr(),
            bufs["p1"].data_ptr(), bufs["h1"].data_ptr(), bufs["h2"].data_ptr(),
            bufs["y"].data_ptr(), bufs["tmp"].data_ptr(), fs._stream(z.device))
    _build.check(lib, status, f"glow_anatomy_reverse ({variant})")
    launches["anatomy_reverse"] += 1
    return bufs["out"]


def _launch_backward(variant: str, weights, z: torch.Tensor, g_zn: torch.Tensor,
                     g_ld: torch.Tensor, patches, bufs):
    hidden = _check("backward", variant, BACKWARD, weights, z, patches)
    b, h, w, c = z.shape
    if g_zn.shape != z.shape or g_ld.shape != (b,):
        raise ValueError(f"cotangents {tuple(g_zn.shape)}, {tuple(g_ld.shape)} do not match "
                         f"z {tuple(z.shape)}")
    if g_zn.device != z.device or g_ld.device != z.device:
        raise ValueError("the cotangents must lie on z's device")
    tile = bwd_tile_batch(b, h, w, c, hidden) * h * w
    if (b * h * w - tile) % fs._TM:
        raise NotImplementedError(f"no_accum cuts every chunking where the last batch tile "
                                  f"starts, pixel {b * h * w - tile}: a multiple of {fs._TM} "
                                  f"pixels only")
    lib = _build.library()
    z, g_zn, g_ld = z.contiguous(), g_zn.float().contiguous(), g_ld.float().contiguous()
    bufs = _buffers("backward", weights, z, bufs)
    with torch.cuda.device(z.device):
        status = lib.glow_anatomy_backward(
            list(BACKWARD).index(variant), b, h, w, c, hidden, tile, z.data_ptr(),
            *(wt.data_ptr() for wt in bufs["weights"]),
            *(t.data_ptr() for t in bufs["transposed"]),
            g_zn.data_ptr(), g_ld.data_ptr(), _ptr(patches), bufs["g_z"].data_ptr(),
            *(g.data_ptr() for g in bufs["grads"]), bufs["workspace"].data_ptr(),
            fs._stream(z.device))
    _build.check(lib, status, f"glow_anatomy_backward ({variant})")
    launches["anatomy_backward"] += 1
    return bufs["g_z"], bufs["grads"]


def forward_variant(variant: str, weights, z: torch.Tensor,
                    patches: torch.Tensor | None = None, buffers: dict | None = None):
    """S1: NHWC z -> (z_next, logdet (B,)); `weights` from
    `fs.pack_weights(step, True, reverse=False)`."""
    if z.device.type == "cpu":
        return forward_variant_ref(variant, weights, z, patches, weights[3].dtype)
    return _launch_forward(variant, weights, z, patches, buffers)


def reverse_variant(variant: str, weights, z: torch.Tensor,
                    patches: torch.Tensor | None = None,
                    buffers: dict | None = None) -> torch.Tensor:
    """S2: the inverse step's variant; `weights` packed with reverse=True."""
    if z.device.type == "cpu":
        return reverse_variant_ref(variant, weights, z, patches, weights[3].dtype)
    return _launch_reverse(variant, weights, z, patches, buffers)


def backward_variant(variant: str, weights, z: torch.Tensor, g_zn: torch.Tensor,
                     g_ld: torch.Tensor, patches: torch.Tensor | None = None,
                     buffers: dict | None = None):
    """S3: (g_z, [12 f32 weight grads]) of the forward step at z."""
    if z.device.type == "cpu":
        return backward_variant_ref(variant, weights, z, g_zn, g_ld, patches, weights[3].dtype)
    return _launch_backward(variant, weights, z, g_zn, g_ld, patches, buffers)
