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

Two kernel paths, chosen by `mix_path` from the shape and the input's
alignment alone, with their kernel launches counted in `path_launches`:
"narrow" (C in `NARROW_C`, x 16-byte aligned), one launch of the
streaming kernel, which for K6a also builds W; "tiled", the tiled mix,
after a build launch for K6a.  Both sum in the same order and give the
same bits.

Gradients: the backward is the plain f32 math, as the JAX kernel's custom
VJP differentiates its XLA twin.  `_Mix` (K6b, y = x @ W^T) returns g @ W
and g^T @ x; `_LUForward` (K6a) returns g @ W and the LU factors' grads in
closed form from gW = g^T @ x (`lu_grads`), with no second autograd pass.
The products are plain matrix products outside any kernel and stay
`torch.matmul`, in full f32 (PyTorch's default `allow_tf32=False`).  Where
autograd records nothing (serving, DDI) the wrappers launch without the
autograd Functions: under no grad a Function's apply adds 7-12 us of host
time to its launch, more than the narrow kernels' 3-7 us of device time
(`scripts/perf_invconv.function_vs_direct`).
"""

from __future__ import annotations

import contextlib

import torch

from pytorch_glow_tpu_torch.ops import _build
from pytorch_glow_tpu_torch.ops import invconv as ic

# The channel counts the narrow kernel is built for (`narrow_kernel<C>`).
NARROW_C = (12, 24, 48)
# (N, C) at which the kernels are held against their plain versions on the
# card (`chip_smoke.py`) and the chooser's outcome on the CPU: the cifar10
# levels at b=256, the celebahq256 DDI widths at b=64, two odd cases, and
# celebahq256's level 0 at b=64, where the narrow kernel's blocks walk
# several row tiles through their ring.
INVCONV_CASES = ((65536, 12), (16384, 24), (4096, 48), (16384, 96), (4096, 192), (1024, 384),
                 (1000, 6), (1025, 130), (1048576, 12))

# Public calls that launched the kernels, one per call.
launches = {"invconv_forward": 0, "invconv_reverse": 0}
# Kernel launches by path, K6a's and K6b's: a narrow call is one launch, a
# tiled K6a call two (the build, then the mix).
path_launches = {"invconv_forward": {"narrow": 0, "tiled": 0},
                 "invconv_reverse": {"narrow": 0, "tiled": 0}}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for counts in path_launches.values():
        for key in counts:
            counts[key] = 0


def mix_path(n: int, c: int, aligned: bool) -> str:
    """The kernel path of an (n, c) mix whose input is (or is not) 16-byte
    aligned: "narrow" for the narrow channel counts, else "tiled"."""
    return "narrow" if n > 0 and c in NARROW_C and aligned else "tiled"


def tensor_path(x: torch.Tensor) -> str:
    """`mix_path` of the kernel input `x`, (..., C) contiguous."""
    c = x.shape[-1]
    return mix_path(x.numel() // c, c, x.data_ptr() % 16 == 0)


def _kernels(x: torch.Tensor) -> bool:
    """Whether `x` goes to the kernels: a CUDA tensor does; a CPU tensor
    takes the plain version."""
    return x.is_cuda


def _check(x: torch.Tensor, c: int, what: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: the 1x1 conv takes float32, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] != c:
        raise ValueError(f"{what}: expected (..., {c}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")


def _check_lu(lu: ic.LUParams, device: int) -> int:
    """The factors' shapes and device (`Tensor.get_device()`: -1 on the CPU)."""
    c = lu.log_s.shape[0]
    for name, t, shape in (("p_idx", lu.p_idx, (c,)), ("l_raw", lu.l_raw, (c, c)),
                           ("u_raw", lu.u_raw, (c, c)), ("log_s", lu.log_s, (c,)),
                           ("sign_s", lu.sign_s, (c,))):
        if t.shape != shape or t.get_device() != device:
            raise ValueError(f"LU {name}: expected {shape} on device {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return c


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` itself where it already is a contiguous `dtype` tensor."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _cuda(x: torch.Tensor) -> int:
    """The CUDA device index of the kernels' input; raises on any other."""
    if not x.is_cuda:
        raise ValueError(f"the 1x1 conv kernels take CUDA tensors, got {x.device}")
    return x.get_device()


def _on(device: int):
    """A context on `device`, entered only where it is not already current."""
    if device == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: int) -> int:
    # The raw handle of the current stream, without a `torch.cuda.Stream`.
    return torch._C._cuda_getCurrentRawStream(device)


def _launch_forward(x: torch.Tensor, p_idx: torch.Tensor, l_raw: torch.Tensor,
                    u_raw: torch.Tensor, log_s: torch.Tensor,
                    sign_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6a on x (..., C) contiguous: -> (y shaped as x, W)."""
    dev = _cuda(x)
    c = x.shape[-1]
    path = tensor_path(x)
    lib = _build.library()
    w = x.new_empty((c, c))
    y = torch.empty_like(x)
    p_idx = _as(p_idx, torch.int64)
    l_raw, u_raw, log_s, sign_s = (_as(t, torch.float32) for t in (l_raw, u_raw, log_s, sign_s))
    with _on(dev):
        status = lib.glow_invconv_forward(
            x.numel() // c, c, path == "narrow", x.data_ptr(), p_idx.data_ptr(),
            l_raw.data_ptr(), u_raw.data_ptr(), log_s.data_ptr(), sign_s.data_ptr(),
            w.data_ptr(), y.data_ptr(), _stream(dev))
    _build.check(lib, status, "glow_invconv_forward")
    path_launches["invconv_forward"][path] += 1 if path == "narrow" else 2
    return y, w


def _launch_mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6b on x (..., C) contiguous: y = x @ w^T, shaped as x."""
    dev = _cuda(x)
    c = x.shape[-1]
    if w.shape != (c, c) or w.dtype != torch.float32 or w.get_device() != dev:
        raise ValueError(f"mix weight: expected ({c}, {c}) float32 on {x.device}, "
                         f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    path = tensor_path(x)
    lib = _build.library()
    w = _as(w, torch.float32)
    y = torch.empty_like(x)
    with _on(dev):
        status = lib.glow_invconv_mix(x.numel() // c, c, path == "narrow", x.data_ptr(),
                                      w.data_ptr(), y.data_ptr(), _stream(dev))
    _build.check(lib, status, "glow_invconv_mix")
    path_launches["invconv_reverse"][path] += 1
    return y


def lu_grads(gw: torch.Tensor, lu: ic.LUParams, need=(True, True, True, True)):
    """The grads of the LU factors (l_raw, u_raw, log_s, sign_s) from gW, the
    grad of W = P L U' (`lu_assemble`), in closed form: with G = P^T gW
    (row p_idx[i] of G is row i of gW), gL = G U'^T and gU' = L^T G, so
    g_l_raw = tril(G U'^T, -1), g_u_raw = triu(L^T G, 1) and, with d =
    diag(L^T G), g_log_s = d sign_s e^log_s, g_sign_s = d e^log_s.  The
    masked triangles get exact zeros.  None where `need` is False."""
    lower, upper = ic.lu_factors(lu)
    big_g = torch.empty_like(gw).index_copy_(0, lu.p_idx.long(), gw)
    g_l = torch.tril(big_g @ upper.T, -1) if need[0] else None
    g_u = g_log_s = g_sign_s = None
    if any(need[1:]):
        g_upper = lower.T @ big_g
        g_u = torch.triu(g_upper, 1) if need[1] else None
        d, e = torch.diagonal(g_upper), torch.exp(lu.log_s.float())
        g_log_s = d * lu.sign_s.float() * e if need[2] else None
        g_sign_s = d * e if need[3] else None
    return g_l, g_u, g_log_s, g_sign_s


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _Mix(torch.autograd.Function):
    """y = x @ W^T by K6b (the mix kernel with a given W), x (..., C)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch_mix(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = _rows(g).T @ _rows(x) if ctx.needs_input_grad[1] else None
        return gx, gw


class _LUForward(torch.autograd.Function):
    """y = x @ W^T with W built from the LU factors, both by K6a, x (..., C)."""

    @staticmethod
    def forward(ctx, x, p_idx, l_raw, u_raw, log_s, sign_s):
        y, w = _launch_forward(x, p_idx, l_raw, u_raw, log_s, sign_s)
        ctx.save_for_backward(x, w, p_idx, l_raw, u_raw, log_s, sign_s)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, *factors = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = g @ w if need[0] else None
        grads = [None] * 4
        if any(need[2:6]):
            grads = lu_grads(_rows(g).T @ _rows(x), ic.LUParams(*factors), need[2:6])
        return (gx, None, *grads)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on `tensors`: without it the
    wrappers launch directly, sparing the autograd Function's apply."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def invconv_lu_forward(x: torch.Tensor, lu: ic.LUParams) -> tuple[torch.Tensor, torch.Tensor]:
    """y[..., :] = W @ x[..., :] and the per-pixel logdet sum(log_s)."""
    c = _check_lu(lu, x.get_device())
    _check(x, c, "invconv_lu_forward")
    if not _kernels(x):
        return ic.mix_channels(x, ic.lu_assemble(lu)), ic.lu_logdet(lu)
    if _needs_grad(x, *lu):
        y = _LUForward.apply(x, *lu)
    else:
        y, _ = _launch_forward(x, *lu)
    launches["invconv_forward"] += 1
    return y, ic.lu_logdet(lu)


def invconv_lu_reverse(y: torch.Tensor, lu: ic.LUParams) -> torch.Tensor:
    """x = W^-1 y over the last axis."""
    c = _check_lu(lu, y.get_device())
    _check(y, c, "invconv_lu_reverse")
    w_inv = ic.lu_inverse(lu)
    if not _kernels(y):
        return ic.mix_channels(y, w_inv)
    x = _Mix.apply(y, w_inv) if _needs_grad(y, w_inv) else _launch_mix(y, w_inv)
    launches["invconv_reverse"] += 1
    return x
