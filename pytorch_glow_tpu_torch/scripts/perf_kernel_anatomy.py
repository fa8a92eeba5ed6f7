"""S1: anatomy of the flow-step forward chain (K1) at celeba64 level 0.

    python -m pytorch_glow_tpu_torch.scripts.perf_kernel_anatomy

Counterpart of the JAX package's `scripts/perf_kernel_anatomy.py`: the same
shape (32x32, c=12, hidden 512, `init_glow` from seed 0, level 0 step 0),
the same variants in the same order, timed by two-N differencing on the
card (`_anatomy`).  Variants (`ops/anatomy.FORWARD`; all but `full` are
wrong math, for attribution only):

  full         the production chain (csrc/flowstep.cu)
  no_logdet    no log_sigmoid sum: ld = 0
  no_masks     3x3 taps read pixel (m + off) mod M, no border test
  no_rolls     taps read pixel m (the zero-conv keeps its masks)
  matmul_only  conv1 reads a given dense patch tensor (no patch staging);
               the zero-conv sums its 9 taps at pixel m

Each row: the variant's us per call, its share of the bound (bf16 products
at 989 TFLOP/s, f32 mix at 67 TFLOP/s, bytes at 3.35 TB/s:
`ops/flowstep.bound_ms`), its time against `full`, and its launches; then `full`'s
device time by kernel (torch.profiler).  Env: KA_BATCH (128), KA_N1/KA_N2
(30/130).  Needs a CUDA card.
"""

from __future__ import annotations

from pytorch_glow_tpu_torch.scripts import _anatomy as A

# (kernel, label, bf16 operations per pixel): the chain's launches in order.
CHAIN = [("mix_tile_kernel", "mix", 0), *A.NET,
         ("coupling_update_kernel", "coupling + logdet partials", 0),
         ("ld_sum_kernel", "logdet sum", 0)]


def main(batch: int | None = None, n1: int | None = None, n2: int | None = None) -> dict:
    b, n1, n2 = A.knobs(batch, n1, n2, 30, 130)
    A.card()
    return A.report("FORWARD", "forward", b, n1, n2, A.operands("forward", b), CHAIN)


if __name__ == "__main__":
    main()
