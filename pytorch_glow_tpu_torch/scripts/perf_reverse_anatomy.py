"""S2: anatomy of the flow-step reverse (sampling) chain (K2) at celeba64
level 0.

    python -m pytorch_glow_tpu_torch.scripts.perf_reverse_anatomy

Counterpart of the JAX package's `scripts/perf_reverse_anatomy.py`: the
same shape, variants and order, timed by two-N differencing on the card
(`_anatomy`).  Variants (`ops/anatomy.REVERSE`; C = correct math, A =
attribution only):

  full         C  the production chain (csrc/flowstep.cu, reverse)
  recip_exp    C  z2 * (1 + e^-(raw+2)) - shift instead of z2 / s - shift
  split_mix    C  the coupling writes z2' alone; the W^-1 mix reads z1 from
                  the input (no z1 copy)
  no_div       A  z2 * s - shift
  no_mix       A  no W^-1 mix and actnorm inverse
  matmul_only  A  conv1 reads a given dense patch tensor (no patch
                  staging); the zero-conv sums its 9 taps at pixel m

A C variant that beats `full` is a candidate edit for K2, to be A/B'd in
the production kernel before it is applied.  Rows as in
`perf_kernel_anatomy`.  Env: KA_BATCH (128), KA_N1/KA_N2 (30/130).  Needs
a CUDA card.
"""

from __future__ import annotations

from pytorch_glow_tpu_torch.scripts import _anatomy as A

# (kernel, label, bf16 operations per pixel): the chain's launches in order.
CHAIN = [*A.NET, ("coupling_update_kernel", "coupling inverse", 0),
         ("mix_tile_kernel", "W^-1 mix + actnorm inverse", 0)]


def main(batch: int | None = None, n1: int | None = None, n2: int | None = None) -> dict:
    b, n1, n2 = A.knobs(batch, n1, n2, 30, 130)
    A.card()
    return A.report("REVERSE", "reverse", b, n1, n2, A.operands("reverse", b), CHAIN)


if __name__ == "__main__":
    main()
