// The flow-step anatomy studies for Hopper (sm_90a): variants of the
// forward (K1), reverse (K2) and backward (K3) chains at one shape, each
// dropping one class of work or swapping in an equivalent formula, so that
// timing them attributes a chain's time to its parts.
//
// Replaces the TPU kernels of the three studies, each reaching
// `pl.pallas_call` through its `run_variant.step`:
//   S1  scripts/perf_kernel_anatomy.py `_make_variant`    (K1's variants)
//   S2  scripts/perf_reverse_anatomy.py `_make_variant`   (K2's variants)
//   S3  scripts/perf_bwd_anatomy.py `_make_variant`, and `full` =
//       `flowstep_pallas._make_bwd_kernel`               (K3's variants)
// Their plain PyTorch versions are `forward_variant_ref`,
// `reverse_variant_ref` and `backward_variant_ref` in
// `pytorch_glow_tpu_torch/ops/anatomy.py`; the timing scripts are
// `pytorch_glow_tpu_torch/scripts/perf_*_anatomy.py`.
//
// Design: a variant is the production chain with one template flag
// changed (flowstep_common.cuh `Tap`, `Form`, the mix's SPLIT, the net's
// STAGED; the core's ROWSUM; flowstep_bwd_common.cuh `BwdProd`), so
// every other kernel of it is the production kernel's own code.  `full`
// is not a copy: it calls the production entry (`glow_flowstep`,
// `glow_flowstep_bwd`).  On this card the chains are several launches,
// so each variant moves the time of identifiable kernels:
//   no_masks     taps read pixel (m + off) mod M with no border test
//                (the TPU's lane roll over one tile, unmasked); conv1's
//                patches are staged so
//   no_rolls     taps read pixel m; masked where the JAX variant keeps its
//                masks (S1's zero-conv), else not
//   matmul_only  conv1 reads a given dense (M, padded(9*ch)) bf16 patch
//                tensor, no patch staging; the zero-conv, gy, g_v1's col2im
//                and (S3) the gW1 patches, staged from v, read their 9 taps
//                at pixel m
//   no_logdet    (S1) no log_sigmoid sum and no partials; ld_sum writes 0
//   recip_exp    (S2) z2 * (1 + e^-(raw+2)) - shift: 1/sigmoid, same math
//   split_mix    (S2) the coupling writes only z2' into an (M, ch) buffer
//                and the W^-1 mix reads z1 from the input (no z1 copy);
//                the mix sums in the same order, so the bits are K2's
//   no_div       (S2) z2 * s - shift
//   no_mix       (S2) no W^-1 mix and actnorm inverse: out = [z1 | z2']
//   no_accum     (S3) the weight grads are the last batch tile's alone, as
//                the JAX variant's (each tile overwrites them): every
//                chunking is cut at the tile's first pixel, every chunk is
//                computed, and each reduction sums the tile's partials only
//   no_rowsum    (S3) no bias/logs column sums and no GEMM-epilogue block
//                partials; those 8 grads are 0
//   no_wgrad     (S3) no weight-gradient product, partial or reduction;
//                all 12 grads are 0, g_z is computed
// Variants marked wrong math exist only to attribute time.  All are affine
// (the studies' coupling) and whole-batch (no row bands).
//
// What bounds them: as K1-K3 (flowstep.cu, flowstep_bwd.cu), operations
// of the coupling net at the celeba64 level-0 shape; every variant does
// the same GEMM work as `full`.

#include "flowstep_bwd_common.cuh"

extern "C" {
int glow_flowstep(int reverse, int affine, int b, int hh, int ww, int c, int hidden,
                  const float* z, const float* wmat, const float* anb, const float* anl,
                  const void* w1, const float* a1b, const float* a1l, const void* w2,
                  const float* a2b, const float* a2l, const void* w3, const float* b3,
                  const float* l3, float* out, float* ld, void* p1, void* h1, void* h2,
                  float* y, float* tmp, void* stream_ptr);
int glow_flowstep_bwd(int affine, int b, int hh, int ww, int c, int hidden, const float* z,
                      const float* wmat, const float* anb, const float* anl, const void* w1,
                      const float* a1b, const float* a1l, const void* w2, const float* a2b,
                      const float* a2l, const void* w3, const float* b3, const float* l3,
                      const void* w1t, const void* w2t, const void* w3t, const float* gzn,
                      const float* gld, float* gz, float* g_wmat, float* g_anb, float* g_anl,
                      float* g_w1, float* g_a1b, float* g_a1l, float* g_w2, float* g_a2b,
                      float* g_a2l, float* g_w3, float* g_b3, float* g_l3, void* workspace,
                      void* stream_ptr);
}

namespace {

enum MixVariant { MIX_PROD = 0, MIX_SPLIT = 1, MIX_NONE = 2 };

// S1: mix, net (conv1 taps TAP1 or staged), coupling (zero-conv taps TAP3)
// with its logdet partials in h1's storage, as glow_flowstep keeps them.
template <int TAP1, int TAP3, bool STAGED, int FORM>
cudaError_t forward_chain(int b, int hh, int ww, int c, int hidden, const float* z,
                          const StepWeights& sw, const void* patches, float* out, float* ld,
                          void* p1, void* h1, void* h2, float* y, cudaStream_t stream) {
  const int M = b * hh * ww;
  GLOW_CHECK(launch_mix<false>(M, c, z, sw.wmat, sw.anb, sw.anl, out, stream));
  GLOW_CHECK((launch_net<false, TAP1, STAGED>(M, hh, ww, c, hidden, c, out, sw, p1, h1, h2, y,
                                              stream, Band{}, patches)));
  return launch_coupling<false, false, TAP3, FORM>(1, b, hh, ww, c, Band{}, out, y, sw.b3, sw.l3,
                                                   out, ld, (float*)h1, stream);
}

// S2: net on the input's z1, coupling into tmp (or out), then the mix.
template <int TAP3, bool STAGED, int FORM, int MIX>
cudaError_t reverse_chain(int b, int hh, int ww, int c, int hidden, const float* z,
                          const StepWeights& sw, const void* patches, float* out, void* p1,
                          void* h1, void* h2, float* y, float* tmp, cudaStream_t stream) {
  const int M = b * hh * ww;
  GLOW_CHECK((launch_net<false, TAP_MASKED, STAGED>(M, hh, ww, c, hidden, c, z, sw, p1, h1, h2, y,
                                                    stream, Band{}, patches)));
  float* dst = MIX == MIX_NONE ? out : tmp;
  GLOW_CHECK((launch_coupling<false, true, TAP3, FORM>(1, b, hh, ww, c, Band{}, z, y, sw.b3, sw.l3,
                                                       dst, nullptr, nullptr, stream)));
  if constexpr (MIX == MIX_SPLIT)
    return launch_mix<true, true>(M, c, z, sw.wmat, sw.anb, sw.anl, out, stream, tmp);
  else if constexpr (MIX == MIX_PROD)
    return launch_mix<true>(M, c, tmp, sw.wmat, sw.anb, sw.anl, out, stream);
  return cudaSuccess;
}

// S3's variants of the backward chain (flowstep_bwd_common.cuh `BwdProd`).
struct NoAccum : BwdProd { static constexpr bool accum = false; };
struct NoRowsum : BwdProd { static constexpr bool rowsum = false; };
struct NoWgrad : BwdProd { static constexpr bool wgrad = false; };
struct NoMasks : BwdProd { static constexpr int tap = TAP_WRAP; };
struct NoRolls : BwdProd { static constexpr int tap = TAP_CENTRE; };
struct MatmulOnly : BwdProd {
  static constexpr int tap = TAP_CENTRE;
  static constexpr bool staged = true;
};

// `split`: the first pixel of the last batch tile (no_accum's cut).
template <class V>
cudaError_t backward_variant(int b, int hh, int ww, int c, int hidden, const float* z,
                             const StepWeights& sw, const void* w1t, const void* w2t,
                             const void* w3t, const float* gzn, const float* gld,
                             const void* patches, float* gz, float* const* g, void* workspace,
                             int split, cudaStream_t stream) {
  const int M = b * hh * ww;
  Carver cv = {(char*)workspace, 0};
  const Workspace ws = carve(cv, M, c, hidden, c, split);
  return backward_chain<false, V>(1, M, hh, ww, c, hidden, Band{}, z, sw, w1t, w2t, w3t, gzn,
                                  gld, gz, g, ws, stream, patches, split);
}

}  // namespace

extern "C" {

// S1, K1's variants (0 full, 1 no_logdet, 2 no_masks, 3 no_rolls,
// 4 matmul_only), affine.  z: (b*hh*ww, c) f32; the 12 packed weights
// (reverse=False; w1 padded as glow_flowstep takes it); patches:
// (M, padded(9*ch)) bf16, read by matmul_only only; out: (M, c); ld: (b,);
// p1: (M, padded(9*ch)) bf16, h1, h2: (M, hidden) bf16 and y: (M, 9*c) f32
// scratch.  Returns 0 or the first launch's cudaError_t.
int glow_anatomy_forward(int variant, int b, int hh, int ww, int c, int hidden, const float* z,
                         const float* wmat, const float* anb, const float* anl, const void* w1,
                         const float* a1b, const float* a1l, const void* w2, const float* a2b,
                         const float* a2l, const void* w3, const float* b3, const float* l3,
                         const void* patches, float* out, float* ld, void* p1, void* h1,
                         void* h2, float* y, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  switch (variant) {
    case 0:
      return glow_flowstep(0, 1, b, hh, ww, c, hidden, z, wmat, anb, anl, w1, a1b, a1l, w2, a2b,
                           a2l, w3, b3, l3, out, ld, p1, h1, h2, y, out, stream_ptr);
    case 1:
      return (int)forward_chain<TAP_MASKED, TAP_MASKED, false, FORM_NO_LOGDET>(
          b, hh, ww, c, hidden, z, sw, patches, out, ld, p1, h1, h2, y, stream);
    case 2:
      return (int)forward_chain<TAP_WRAP, TAP_WRAP, false, FORM_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, ld, p1, h1, h2, y, stream);
    case 3:
      return (int)forward_chain<TAP_CENTRE, TAP_CENTRE_MASKED, false, FORM_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, ld, p1, h1, h2, y, stream);
    case 4:
      return (int)forward_chain<TAP_MASKED, TAP_CENTRE, true, FORM_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, ld, p1, h1, h2, y, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// S2, K2's variants (0 full, 1 recip_exp, 2 split_mix, 3 no_div, 4 no_mix,
// 5 matmul_only), affine.  As glow_anatomy_forward, with the weights
// packed reverse=True, no logdet, and tmp: (M, c) f32 scratch.
int glow_anatomy_reverse(int variant, int b, int hh, int ww, int c, int hidden, const float* z,
                         const float* wmat, const float* anb, const float* anl, const void* w1,
                         const float* a1b, const float* a1l, const void* w2, const float* a2b,
                         const float* a2l, const void* w3, const float* b3, const float* l3,
                         const void* patches, float* out, void* p1, void* h1, void* h2,
                         float* y, float* tmp, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  switch (variant) {
    case 0:
      return glow_flowstep(1, 1, b, hh, ww, c, hidden, z, wmat, anb, anl, w1, a1b, a1l, w2, a2b,
                           a2l, w3, b3, l3, out, nullptr, p1, h1, h2, y, tmp, stream_ptr);
    case 1:
      return (int)reverse_chain<TAP_MASKED, false, FORM_RECIP_EXP, MIX_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, p1, h1, h2, y, tmp, stream);
    case 2:
      return (int)reverse_chain<TAP_MASKED, false, FORM_SPLIT, MIX_SPLIT>(
          b, hh, ww, c, hidden, z, sw, patches, out, p1, h1, h2, y, tmp, stream);
    case 3:
      return (int)reverse_chain<TAP_MASKED, false, FORM_NO_DIV, MIX_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, p1, h1, h2, y, tmp, stream);
    case 4:
      return (int)reverse_chain<TAP_MASKED, false, FORM_PROD, MIX_NONE>(
          b, hh, ww, c, hidden, z, sw, patches, out, p1, h1, h2, y, tmp, stream);
    case 5:
      return (int)reverse_chain<TAP_CENTRE, true, FORM_PROD, MIX_PROD>(
          b, hh, ww, c, hidden, z, sw, patches, out, p1, h1, h2, y, tmp, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch `glow_anatomy_backward` needs: the backward chain's,
// with every chunking cut where the last batch tile of `tile` pixels
// starts.
size_t glow_anatomy_bwd_workspace(int b, int hh, int ww, int c, int hidden, int tile) {
  const int M = b * hh * ww;
  Carver cv = {nullptr, 0};
  return carve(cv, M, c, hidden, c, M - tile).bytes;
}

// S3, K3's variants (0 full, 1 no_accum, 2 no_rowsum, 3 no_wgrad,
// 4 no_masks, 5 no_rolls, 6 matmul_only), affine.  Arguments as
// glow_flowstep_bwd's, plus patches ((M, padded(9*ch)) bf16, matmul_only) and
// tile, the pixels of the JAX study's batch tile (no_accum keeps the last
// one's grads; M - tile a multiple of 128); the workspace is
// glow_anatomy_bwd_workspace's size.
int glow_anatomy_backward(int variant, int b, int hh, int ww, int c, int hidden, int tile,
                          const float* z, const float* wmat, const float* anb, const float* anl,
                          const void* w1, const float* a1b, const float* a1l, const void* w2,
                          const float* a2b, const float* a2l, const void* w3, const float* b3,
                          const float* l3, const void* w1t, const void* w2t, const void* w3t,
                          const float* gzn, const float* gld, const void* patches, float* gz,
                          float* g_wmat, float* g_anb, float* g_anl, float* g_w1, float* g_a1b,
                          float* g_a1l, float* g_w2, float* g_a2b, float* g_a2l, float* g_w3,
                          float* g_b3, float* g_l3, void* workspace, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  float* const g[N_WEIGHTS] = {g_wmat, g_anb, g_anl, g_w1, g_a1b, g_a1l,
                               g_w2,   g_a2b, g_a2l, g_w3, g_b3,  g_l3};
  const int split = b * hh * ww - tile;
  switch (variant) {
    case 0:
      return glow_flowstep_bwd(1, b, hh, ww, c, hidden, z, wmat, anb, anl, w1, a1b, a1l, w2, a2b,
                               a2l, w3, b3, l3, w1t, w2t, w3t, gzn, gld, gz, g_wmat, g_anb, g_anl,
                               g_w1, g_a1b, g_a1l, g_w2, g_a2b, g_a2l, g_w3, g_b3, g_l3,
                               workspace, stream_ptr);
    case 1:
      return (int)backward_variant<NoAccum>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn, gld,
                                            patches, gz, g, workspace, split, stream);
    case 2:
      return (int)backward_variant<NoRowsum>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn,
                                             gld, patches, gz, g, workspace, split, stream);
    case 3:
      return (int)backward_variant<NoWgrad>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn, gld,
                                            patches, gz, g, workspace, split, stream);
    case 4:
      return (int)backward_variant<NoMasks>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn, gld,
                                            patches, gz, g, workspace, split, stream);
    case 5:
      return (int)backward_variant<NoRolls>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn, gld,
                                            patches, gz, g, workspace, split, stream);
    case 6:
      return (int)backward_variant<MatmulOnly>(b, hh, ww, c, hidden, z, sw, w1t, w2t, w3t, gzn,
                                               gld, patches, gz, g, workspace, split, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
