"""The LU 1x1 conv through the hand-written kernels of `csrc/invconv.cu`.

Counterpart of `pytorch_glow_tpu/ops/invconv_pallas.py`, which the JAX
package selects with `invconv_impl="pallas"`:

* `invconv_lu_forward(x, lu)` -> (y, logdet): K6a builds W from the LU
  factors and mixes the pixel batch, y = x @ W^T.  The logdet is sum(log_s),
  computed outside the kernel, as the JAX wrapper does (its kernel's SMEM
  logdet is discarded).
* `invconv_lu_reverse(y, lu)` -> x: W^-1 from two triangular solves
  (`ops/invconv.lu_inverse`, left to the library as the JAX package leaves
  them to XLA), then K6b mixes, x = y @ W^-T.

Both take (..., C) float32 contiguous tensors.  A CPU tensor runs the plain
version (`lu_assemble` / `lu_inverse` / `mix_channels`); a CUDA tensor
launches the kernels or raises.  Nothing falls back.

Gradients: the backward is the plain f32 math, as the JAX kernel's custom
VJP differentiates its XLA twin.  `_Mix` (K6b, y = x @ W^T) returns g @ W
and g^T @ x; `_LUForward` (K6a) returns g @ W and pushes g^T @ x through
`lu_assemble` by autograd to the LU factors.  The
products are plain large matrix products outside any kernel and stay
`torch.matmul`, in full f32 (PyTorch's default `allow_tf32=False`).
"""

from __future__ import annotations

import torch

from pytorch_glow_tpu_torch.ops import _build
from pytorch_glow_tpu_torch.ops import invconv as ic

# Public calls that launched the kernels, one per call.
launches = {"invconv_forward": 0, "invconv_reverse": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(x: torch.Tensor, c: int, what: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: the 1x1 conv takes float32, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] != c:
        raise ValueError(f"{what}: expected (..., {c}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")


def _check_lu(lu: ic.LUParams, device: torch.device) -> int:
    c = lu.log_s.shape[0]
    shapes = {"p_idx": (c,), "l_raw": (c, c), "u_raw": (c, c), "log_s": (c,), "sign_s": (c,)}
    for name, shape in shapes.items():
        t = getattr(lu, name)
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"LU {name}: expected {shape} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return c


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the 1x1 conv kernels take CUDA tensors, got {x.device}")
    return x


def _launch_forward(x2d: torch.Tensor, lu: ic.LUParams) -> tuple[torch.Tensor, torch.Tensor]:
    """K6a: -> (y, W)."""
    dev = _on_cuda(x2d).device
    n, c = x2d.shape
    lib = _build.library()
    w = torch.empty(c, c, dtype=torch.float32, device=dev)
    y = torch.empty_like(x2d)
    p_idx = lu.p_idx.to(torch.int64).contiguous()
    factors = [t.float().contiguous() for t in (lu.l_raw, lu.u_raw, lu.log_s, lu.sign_s)]
    with torch.cuda.device(dev):
        status = lib.glow_invconv_forward(
            n, c, x2d.data_ptr(), p_idx.data_ptr(), *(t.data_ptr() for t in factors),
            w.data_ptr(), y.data_ptr(), _stream(dev))
    _build.check(lib, status, "glow_invconv_forward")
    return y, w


def _launch_mix(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6b: y = x @ w^T."""
    dev = _on_cuda(x2d).device
    n, c = x2d.shape
    if tuple(w.shape) != (c, c) or w.dtype != torch.float32 or w.device != dev:
        raise ValueError(f"mix weight: expected ({c}, {c}) float32 on {dev}, "
                         f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    lib = _build.library()
    w = w.contiguous()
    y = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        status = lib.glow_invconv_mix(n, c, x2d.data_ptr(), w.data_ptr(), y.data_ptr(),
                                      _stream(dev))
    _build.check(lib, status, "glow_invconv_mix")
    return y


class _Mix(torch.autograd.Function):
    """y = x @ W^T by K6b (the mix kernel with a given W)."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return _launch_mix(x2d, w)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = g.T @ x2d if ctx.needs_input_grad[1] else None
        return gx, gw


class _LUForward(torch.autograd.Function):
    """y = x @ W^T with W built from the LU factors, both by K6a."""

    @staticmethod
    def forward(ctx, x2d, p_idx, l_raw, u_raw, log_s, sign_s):
        lu = ic.LUParams(p_idx, l_raw, u_raw, log_s, sign_s)
        y, w = _launch_forward(x2d, lu)
        ctx.save_for_backward(x2d, w, p_idx, l_raw, u_raw, log_s, sign_s)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, w, p_idx, *factors = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = g @ w if need[0] else None
        grads = [None] * 4
        if any(need[2:6]):
            gw = g.T @ x2d
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in zip(factors, need[2:6])]
                w_ref = ic.lu_assemble(ic.LUParams(p_idx, *leaves))
                wanted = [t for t in leaves if t.requires_grad]
                got = iter(torch.autograd.grad(w_ref, wanted, gw, allow_unused=True))
            grads = [next(got) if t.requires_grad else None for t in leaves]
        return (gx, None, *grads)


def invconv_lu_forward(x: torch.Tensor, lu: ic.LUParams) -> tuple[torch.Tensor, torch.Tensor]:
    """y[..., :] = W @ x[..., :] and the per-pixel logdet sum(log_s)."""
    c = _check_lu(lu, x.device)
    _check(x, c, "invconv_lu_forward")
    if x.device.type == "cpu":
        return ic.mix_channels(x, ic.lu_assemble(lu)), ic.lu_logdet(lu)
    x2d = x.view(-1, c)
    y = _LUForward.apply(x2d, lu.p_idx, lu.l_raw, lu.u_raw, lu.log_s, lu.sign_s)
    launches["invconv_forward"] += 1
    return y.view(x.shape), ic.lu_logdet(lu)


def invconv_lu_reverse(y: torch.Tensor, lu: ic.LUParams) -> torch.Tensor:
    """x = W^-1 y over the last axis."""
    c = _check_lu(lu, y.device)
    _check(y, c, "invconv_lu_reverse")
    w_inv = ic.lu_inverse(lu)
    if y.device.type == "cpu":
        return ic.mix_channels(y, w_inv)
    x = _Mix.apply(y.view(-1, c), w_inv)
    launches["invconv_reverse"] += 1
    return x.view(y.shape)
