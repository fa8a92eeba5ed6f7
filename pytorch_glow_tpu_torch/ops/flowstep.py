"""The fused flow step: weight packing, its plain PyTorch version, the
wrappers that launch the hand-written CUDA kernels, and the autograd
Functions around them.

Counterpart of the non-kernel parts of `pytorch_glow_tpu/ops/flowstep_pallas.py`
(`pack_weights`, `_cross_perm`, `param_logdet`, `step_forward`,
`step_reverse`, `step_backward_t`) and of the custom VJPs in
`pytorch_glow_tpu/models/glow.py` (`_fused_step_forward`,
`_fused_step_reverse`).  `csrc/flowstep.cu` replaces that module's
`_make_kernel` (reverse=False and reverse=True), `csrc/flowstep_bwd.cu` its
`_make_bwd_kernel`.

Layout: the port keeps NHWC at its public functions, which is already
pixel-major; the kernels take the (B*H*W, C) view of it.

`step_forward` / `step_reverse` / `step_backward` pick the implementation
from the tensor's device only: a CPU tensor runs the plain version `step_*_ref`, a CUDA tensor
launches the kernel chain or raises.  Nothing falls back.

The plain version computes the kernel's math, not the layer math of
`models/layers.py`: f32 actnorm and f32 mix; coupling-net operands rounded
to bf16 and multiplied in f32 (exact products, f32 sums, as the JAX
kernel's `_dot_bf16` in interpret mode); the conv actnorms in f32 before
the bf16 cast.  It runs at the coupling dtype of the packed w1 (bf16, or
f32 where a test packs f32 weights to check the algebra).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_glow_tpu_torch.ops import _build

COUPLING_DTYPE = torch.bfloat16
N_WEIGHTS = 12

# Kernel launches per direction; one per flow step launched on the card.
launches = {"forward": 0, "reverse": 0, "backward": 0}


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
                 coupling_dtype: torch.dtype = COUPLING_DTYPE) -> list[torch.Tensor]:
    """One `FlowStep` module -> the 12 kernel operands, in the JAX kernel's
    order, shapes and dtypes (column vectors are (r, 1) f32)."""
    conv1, conv2, conv3 = step.f[0], step.f[2], step.f[4]
    hidden = conv1.weight.shape[0]
    cout = conv3.weight.shape[0]
    # (cout, hid, 3, 3) -> rows (tap, cout in [shift | raw] order), cols hid
    w3t = _cross_perm(conv3.weight, affine).permute(2, 3, 0, 1).reshape(9 * cout, hidden)
    # (hid, cin, 3, 3) -> rows hid, cols (tap, cin)
    w1t = conv1.weight.permute(0, 2, 3, 1).reshape(hidden, -1)

    def col(v):
        return v.reshape(-1, 1).float()

    return [
        step.invconv.weight(reverse=reverse).float(),
        col(step.actnorm.bias),
        col(step.actnorm.logs),
        w1t.to(coupling_dtype),
        col(conv1.actnorm.bias),
        col(conv1.actnorm.logs),
        conv2.weight.reshape(hidden, hidden).to(coupling_dtype),
        col(conv2.actnorm.bias),
        col(conv2.actnorm.logs),
        w3t.to(coupling_dtype),
        col(_cross_perm(conv3.bias, affine)),
        col(_cross_perm(conv3.logs.reshape(-1), affine)),
    ]


def param_logdet(step) -> torch.Tensor:
    """Per-pixel logdet of actnorm + 1x1 conv for ONE step (the z-free
    terms the kernel does not emit); multiply by H*W outside."""
    return step.actnorm.logs.sum() + step.invconv.logdet()


def supported(h: int, w: int, c: int, hidden: int, affine: bool = True,
              b: int | None = None) -> bool:
    """Shapes the CUDA kernel chain takes.  It stages h1, h2 and the
    tap-packed conv3 output in device memory, so no on-chip budget bounds
    the image; the bound is its 32-bit element indexing of those buffers."""
    if c < 2 or c % 2 or hidden < 1 or h < 1 or w < 1:
        return False
    cout = c if affine else c // 2
    rows = (b or 1) * h * w
    return rows * max(hidden, 9 * cout, c) < 2**31


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


def _net_parts(z1: torch.Tensor, weights, dtype: torch.dtype):
    """The coupling net f() as the kernel computes it, with its
    intermediates: NHWC z1 (f32) -> (p1, h1, h2, out (B, H, W, cout) f32)."""
    _, _, _, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    b, h, w, _ = z1.shape
    cout = w3.shape[0] // 9
    p1 = torch.cat(_taps(z1.float()), dim=-1).to(dtype).float()
    a = p1 @ w1.float().T
    a = (a + a1b.view(-1)) * torch.exp(a1l.view(-1))
    h1 = torch.relu(a).to(dtype).float()
    a = h1 @ w2.float().T
    a = (a + a2b.view(-1)) * torch.exp(a2l.view(-1))
    h2 = torch.relu(a).to(dtype).float()
    y = h2 @ w3.float().T  # tap-packed zero-conv: (B, H, W, 9*cout)
    acc = torch.zeros(b, h, w, cout, dtype=torch.float32, device=z1.device)
    for k, tap in enumerate(_taps(y)):
        acc = acc + tap[..., k * cout:(k + 1) * cout]
    return p1, h1, h2, (acc + b3.view(-1)) * torch.exp(l3.view(-1) * 3.0)


def _net_ref(z1: torch.Tensor, weights, dtype: torch.dtype) -> torch.Tensor:
    """The coupling net f(): NHWC z1 (f32) -> (B, H, W, cout) f32."""
    return _net_parts(z1, weights, dtype)[3]


def step_forward_ref(weights, z: torch.Tensor, affine: bool,
                     dtype: torch.dtype = COUPLING_DTYPE):
    """NHWC z -> (z_next, coupling logdet (B,)), the kernel's math in PyTorch."""
    wmat, anb, anl = weights[:3]
    ch = z.shape[-1] // 2
    z = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    z = z @ wmat.T
    z1, z2 = z[..., :ch], z[..., ch:]
    h = _net_ref(z1, weights, dtype)
    if affine:
        shift, raw = h[..., :ch], h[..., ch:]
        z2 = (z2 + shift) * torch.sigmoid(raw + 2.0)
        ld = F.logsigmoid(raw + 2.0).sum(dim=(1, 2, 3))
    else:
        z2 = z2 + h
        ld = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    return torch.cat([z1, z2], dim=-1), ld


def step_reverse_ref(weights, z: torch.Tensor, affine: bool,
                     dtype: torch.dtype = COUPLING_DTYPE) -> torch.Tensor:
    """Inverse of `step_forward_ref` (weights packed with reverse=True)."""
    wmat, anb, anl = weights[:3]
    ch = z.shape[-1] // 2
    z = z.float()
    z1, z2 = z[..., :ch], z[..., ch:]
    h = _net_ref(z1, weights, dtype)
    if affine:
        shift, raw = h[..., :ch], h[..., ch:]
        z2 = z2 / torch.sigmoid(raw + 2.0) - shift
    else:
        z2 = z2 - h
    z = torch.cat([z1, z2], dim=-1) @ wmat.T
    return z * torch.exp(-anl.view(-1)) - anb.view(-1)


def step_backward_ref(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                      affine: bool, dtype: torch.dtype = COUPLING_DTYPE):
    """The backward of `step_forward_ref`, written out as the kernel computes
    it (the JAX kernel's `_make_bwd_kernel` math): recompute, then the
    cotangents.  NHWC z, g_zn (cotangent of z_next) and g_ld (B,) ->
    (g_z, [12 f32 weight grads in the packed shapes]).  bf16 roundings at the
    kernel's places: the patches, h1, h2, gy, g_a2 and g_a1."""
    wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3 = weights
    ch = z.shape[-1] // 2

    def cast(t):
        return t.to(dtype).float()

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def colsum(t):
        return flat(t).sum(0).reshape(-1, 1)

    u = (z.float() + anb.view(-1)) * torch.exp(anl.view(-1))
    v = u @ wmat.T
    v2 = v[..., ch:]
    p1, h1, h2, out = _net_parts(v[..., :ch], weights, dtype)
    g_zn = g_zn.float()
    go1, go2 = g_zn[..., :ch], g_zn[..., ch:]
    if affine:
        shift = out[..., :ch]
        s = torch.sigmoid(out[..., ch:] + 2.0)
        # The saturation-safe form: g_ld * (1 - s) is d log_sigmoid / d raw,
        # finite where s underflows to 0.
        g_raw = go2 * (v2 + shift) * (s * (1.0 - s)) + g_ld.float().view(-1, 1, 1, 1) * (1.0 - s)
        g_v2 = go2 * s
        g_out = torch.cat([g_v2, g_raw], dim=-1)
    else:
        g_v2 = g_out = go2
    g_acc = g_out * torch.exp(l3.view(-1) * 3.0)
    gy = cast(torch.cat([_shift_back(g_acc, k) for k in range(9)], dim=-1))

    g_a2n = (gy @ w3.float()) * (h2 > 0)
    g_a2 = g_a2n * torch.exp(a2l.view(-1))
    g_a2b = cast(g_a2)
    g_a1n = (g_a2b @ w2.float()) * (h1 > 0)
    g_a1 = g_a1n * torch.exp(a1l.view(-1))
    g_a1b = cast(g_a1)
    g_p1 = g_a1b @ w1.float()
    g_v1 = go1
    for k in range(9):
        g_v1 = g_v1 + _shift_back(g_p1[..., k * ch:(k + 1) * ch], k)
    g_v = torch.cat([g_v1, g_v2], dim=-1)
    g_u = g_v @ wmat
    g_z = g_u * torch.exp(anl.view(-1))
    grads = [
        flat(g_v).T @ flat(u), colsum(g_z), colsum(g_u * u),
        flat(g_a1b).T @ flat(p1), colsum(g_a1), colsum(g_a1n * h1),
        flat(g_a2b).T @ flat(h1), colsum(g_a2), colsum(g_a2n * h2),
        flat(gy).T @ flat(h2), colsum(g_acc), 3.0 * colsum(g_out * out),
    ]
    return g_z, grads


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(weights, z: torch.Tensor, affine: bool,
                    halo: str = "_make_kernel_halo") -> tuple[int, int]:
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
    if not supported(h, w, c, hidden, affine, b):
        raise NotImplementedError(
            f"flow-step kernel does not take (b={b}, h={h}, w={w}, c={c}, "
            f"hidden={hidden}); the halo-tiled kernel (flowstep_pallas "
            f"{halo}) is not yet ported"
        )
    return hidden, cout


def _launch(weights, z: torch.Tensor, affine: bool, reverse: bool):
    hidden, cout = _check_operands(weights, z, affine)
    lib = _build.library()
    b, h, w, c = z.shape
    m = b * h * w
    z = z.contiguous()
    dev = z.device
    out = torch.empty_like(z)
    ld = torch.empty(b, dtype=torch.float32, device=dev)
    h1 = torch.empty(m, hidden, dtype=torch.bfloat16, device=dev)
    h2 = torch.empty(m, hidden, dtype=torch.bfloat16, device=dev)
    y = torch.empty(m, 9 * cout, dtype=torch.float32, device=dev)
    tmp = torch.empty_like(z) if reverse else out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.glow_flowstep(
            int(reverse), int(affine), b, h, w, c, hidden,
            z.data_ptr(), *(wt.data_ptr() for wt in weights),
            out.data_ptr(), ld.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            y.data_ptr(), tmp.data_ptr(), stream,
        )
    _build.check(lib, status, "glow_flowstep")
    launches["reverse" if reverse else "forward"] += 1
    return out, ld


def _launch_backward(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                     affine: bool):
    hidden, _ = _check_operands(weights, z, affine, halo="_make_bwd_kernel_halo")
    b, h, w, c = z.shape
    if g_zn.shape != z.shape or g_ld.shape != (b,):
        raise ValueError(f"cotangents {tuple(g_zn.shape)}, {tuple(g_ld.shape)} do not match "
                         f"z {tuple(z.shape)}")
    if g_zn.device != z.device or g_ld.device != z.device:
        raise ValueError("the cotangents must lie on z's device")
    lib = _build.library()
    dev = z.device
    z = z.contiguous()
    g_zn = g_zn.float().contiguous()
    g_ld = g_ld.float().contiguous()
    transposed = [weights[i].t().contiguous() for i in (3, 6, 9)]  # w1t, w2t, w3t
    g_z = torch.empty_like(z)
    grads = [torch.empty(wt.shape, dtype=torch.float32, device=dev) for wt in weights]
    nbytes = lib.glow_flowstep_bwd_workspace(int(affine), b, h, w, c, hidden)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.glow_flowstep_bwd(
            int(affine), b, h, w, c, hidden,
            z.data_ptr(), *(wt.data_ptr() for wt in weights),
            *(wt.data_ptr() for wt in transposed), g_zn.data_ptr(), g_ld.data_ptr(),
            g_z.data_ptr(), *(g.data_ptr() for g in grads), workspace.data_ptr(), stream,
        )
    _build.check(lib, status, "glow_flowstep_bwd")
    launches["backward"] += 1
    return g_z, grads


def step_forward(weights, z: torch.Tensor, affine: bool):
    """NHWC z -> (z_next, coupling logdet (B,)); `weights` from
    `pack_weights(..., reverse=False)`."""
    if z.device.type == "cpu":
        return step_forward_ref(weights, z, affine, weights[3].dtype)
    return _launch(weights, z, affine, reverse=False)


def step_reverse(weights, z: torch.Tensor, affine: bool) -> torch.Tensor:
    """Inverse step; `weights` from `pack_weights(..., reverse=True)`."""
    if z.device.type == "cpu":
        return step_reverse_ref(weights, z, affine, weights[3].dtype)
    out, _ = _launch(weights, z, affine, reverse=True)
    return out


def step_backward(weights, z: torch.Tensor, g_zn: torch.Tensor, g_ld: torch.Tensor,
                  affine: bool):
    """Backward of `step_forward` at input z: (g_z, [12 f32 weight grads])."""
    if z.device.type == "cpu":
        return step_backward_ref(weights, z, g_zn, g_ld, affine, weights[3].dtype)
    return _launch_backward(weights, z, g_zn, g_ld, affine)


# ---------------------------------------------------------------------------
# Autograd around the kernels
# ---------------------------------------------------------------------------


class FusedStep(torch.autograd.Function):
    """(z, affine, *packed) -> (z_next, logdet): the forward kernel, and a
    backward that recomputes the step inside the backward kernel from the
    saved input, as the JAX package's custom VJP does.  Weight grads come
    back in the packed dtypes (bf16 for w1, w2, w3, as the JAX package
    rounds them); `pack_weights`' own autograd maps them to the parameters.
    Under `torch.no_grad()` apply records no graph and keeps no residuals."""

    @staticmethod
    def forward(ctx, z, affine, *weights):
        ctx.affine = affine
        ctx.save_for_backward(z, *weights)
        return step_forward(weights, z, affine)

    @staticmethod
    def backward(ctx, g_zn, g_ld):
        z, *weights = ctx.saved_tensors
        g_z, grads = step_backward(weights, z, g_zn, g_ld, ctx.affine)
        return (g_z, None, *(g.to(wt.dtype) for g, wt in zip(grads, weights)))


class FusedStepReverse(torch.autograd.Function):
    """(z, affine, *packed reverse) -> z_prev: the reverse kernel, and
    autograd over the plain version for the backward (sampling is not
    trained through, so no kernel; the JAX package differentiates its XLA
    math there too)."""

    @staticmethod
    def forward(ctx, z, affine, *weights):
        ctx.affine = affine
        ctx.save_for_backward(z, *weights)
        return step_reverse(weights, z, affine)

    @staticmethod
    def backward(ctx, g):
        z, *weights = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = step_reverse_ref(weights, z, ctx.affine, weights[3].dtype)
            grads = torch.autograd.grad(out, [z, *weights], g)
        return (grads[0], None, *grads[1:])

