"""S3: anatomy of the flow-step backward (training) chain (K3) at celeba64
level 0.

    python -m pytorch_glow_tpu_torch.scripts.perf_bwd_anatomy

Counterpart of the JAX package's `scripts/perf_bwd_anatomy.py`: the same
shape, variants and order, g_zn normal and g_ld = 1, timed by two-N
differencing on the card (`_anatomy`).  Variants (`ops/anatomy.BACKWARD`;
all but `full` are wrong math, for attribution only):

  full         the production chain (csrc/flowstep_bwd.cu): recompute on
               the forward's `launch_net` (conv1's patches staged once,
               kept for gW1), recompute, dgrad and wgrad products on the
               wgmma/TMA core, column sums, chunk reductions
  no_accum     the JAX variant's: the grads of the last batch tile alone;
               every chunk computed, each reduction over the tile's
               partials only
  no_rowsum    no bias/logs column sums or GEMM-epilogue block partials
  no_wgrad     no weight-gradient product, partial or reduction
               (recompute + dgrad: the cost of g_z alone)
  no_masks     every 3x3 read (conv1, zero-conv, gy, g_v1, the staged
               patches) at pixel (m + off) mod M, no border test
  no_rolls     every 3x3 read at pixel m
  matmul_only  conv1 reads a given dense patch tensor; the zero-conv,
               gy, g_v1 and gW1's patches (staged from v after gW2) read
               their taps at pixel m

The bound counts the recompute, dgrad and wgrad products (3x the forward's
net) and the f32 mix products.  Rows as in `perf_kernel_anatomy`, and
`full`'s device time by kernel splits the chain into recompute, dgrad,
wgrad, the partials and the reductions.  Env: KA_BATCH (128), KA_N1/KA_N2
(20/70).  Needs a CUDA card.
"""

from __future__ import annotations

from pytorch_glow_tpu_torch.scripts import _anatomy as A

# (kernel, label, bf16 operations per pixel): the chain's launches in order.
_REDUCE = ("reduce_partials_kernel", "reductions of chunk partials", 0)
_COLS = ("col_partial_kernel", "column-sum partials", 0)
_P1, _H, _Y, _CORE = A.CONV1_OPS, A.CONV2_OPS, A.CONV3_OPS, A.CORE
CHAIN = [
    ("mix_tile_kernel", "recompute: mix", 0),
    *((name, f"recompute: {label}", ops) for name, label, ops in A.NET),
    ("coupling_bwd_kernel", "coupling backward", 0), ("gy_kernel", "gy (zero-conv transpose)", 0),
    (_CORE, "dgrad: g_h2 GEMM + block partials", _Y),
    (_CORE, "dgrad: g_h1 GEMM + block partials", _H),
    (_CORE, "dgrad: g_p1 GEMM", _P1),
    ("gv1_kernel", "g_v1 col2im", 0), ("mix_tile_kernel", "mix backward", 0),
    (_CORE, "wgrad: gW2 GEMM", _H), _REDUCE,
    (_CORE, "wgrad: gW1 GEMM (the recompute's patches)", _P1), _REDUCE,
    (_CORE, "wgrad: gW3 GEMM", _Y), _REDUCE,
    _REDUCE, _REDUCE, _REDUCE, _REDUCE,
    _COLS, _REDUCE, _COLS, _REDUCE, _COLS, _REDUCE, _COLS, _REDUCE,
    # one thread per output below C = 32, else the tiled mix's MIX_OUTER form
    ("outer_partial_kernel|mix_tile_kernel", "mix-gradient partials", 0), _REDUCE,
]


def main(batch: int | None = None, n1: int | None = None, n2: int | None = None) -> dict:
    b, n1, n2 = A.knobs(batch, n1, n2, 20, 70)
    A.card()
    return A.report("BACKWARD", "backward", b, n1, n2, A.operands("backward", b), CHAIN)


if __name__ == "__main__":
    main()
