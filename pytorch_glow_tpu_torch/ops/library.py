"""The hand-written kernels as `torch.library` custom ops, for `torch.export`.

The kernel wrappers launch through ctypes with each operand's `data_ptr()`
and pick their tiling from concrete sizes (`ops/flowstep.tiling`,
`_require_supported`), neither of which a traced graph can hold.  As
custom ops the exporter keeps them opaque: their fake functions give only
the outputs' shapes, and the implementation runs at call time on concrete
tensors, through the same wrappers the live path calls:

  glow::flowstep_forward(z, affine, weights) -> (z_next, logdet)
      `ops/flowstep.step_forward`: K1 on the whole batch or K4 on row bands
  glow::flowstep_reverse(z, affine, weights) -> z_prev
      `ops/flowstep.step_reverse`: K2 or K4's reverse
  glow::invconv_lu_forward(x, p_idx, l_raw, u_raw, log_s, sign_s) -> y
      `ops/invconv_fused._launch_forward`: K6a (W built from the LU factors)
  glow::invconv_mix(x, w) -> y
      `ops/invconv_fused._launch_mix`: K6b (y = x @ w^T)

Each counts its launches where the wrapper does (`flowstep.launches`,
`invconv_fused.launches` and `path_launches`).  On CPU tensors each op runs
the kernel's plain version, so an artifact exported with the kernels
(`serve.export_artifact(keep_kernels=True)`) exports and serves on the CPU
too; on a CUDA tensor it launches the kernel or raises.

Only exported graphs call these ops (`torch.compiler.is_exporting()` in
`models/glow.py` and `ops/invconv_fused.py`); the live eager path calls the
wrappers directly, which spares the dispatcher's host time
(`scripts/perf_invconv.op_vs_direct`).  Importing this module registers
the ops: a served artifact needs it and nothing of the model code.
"""

from __future__ import annotations

import torch

from pytorch_glow_tpu_torch.ops import flowstep as fs
from pytorch_glow_tpu_torch.ops import invconv as ic
from pytorch_glow_tpu_torch.ops import invconv_fused as icf


@torch.library.custom_op("glow::flowstep_forward", mutates_args=())
def flowstep_forward(z: torch.Tensor, affine: bool,
                     weights: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    return fs.step_forward(weights, z, affine)


@flowstep_forward.register_fake
def _(z, affine, weights):
    return torch.empty_like(z), z.new_empty(z.shape[0])


@torch.library.custom_op("glow::flowstep_reverse", mutates_args=())
def flowstep_reverse(z: torch.Tensor, affine: bool, weights: list[torch.Tensor]) -> torch.Tensor:
    return fs.step_reverse(weights, z, affine)


@flowstep_reverse.register_fake
def _(z, affine, weights):
    return torch.empty_like(z)


@torch.library.custom_op("glow::invconv_lu_forward", mutates_args=())
def invconv_lu_forward(x: torch.Tensor, p_idx: torch.Tensor, l_raw: torch.Tensor,
                       u_raw: torch.Tensor, log_s: torch.Tensor,
                       sign_s: torch.Tensor) -> torch.Tensor:
    if not icf._kernels(x):
        return ic.mix_channels(x, ic.lu_assemble(ic.LUParams(p_idx, l_raw, u_raw, log_s, sign_s)))
    y, _ = icf._launch_forward(x, p_idx, l_raw, u_raw, log_s, sign_s)
    icf.launches["invconv_forward"] += 1
    return y


@invconv_lu_forward.register_fake
def _(x, p_idx, l_raw, u_raw, log_s, sign_s):
    return torch.empty_like(x)


@torch.library.custom_op("glow::invconv_mix", mutates_args=())
def invconv_mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not icf._kernels(x):
        return ic.mix_channels(x, w)
    y = icf._launch_mix(x, w)
    icf.launches["invconv_reverse"] += 1
    return y


@invconv_mix.register_fake
def _(x, w):
    return torch.empty_like(x)
