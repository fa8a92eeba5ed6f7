// The Glow flow step's backward for Hopper (sm_90a): recompute, then the
// cotangents of z and of all 12 packed weights, as a chain of kernels.
//
// Replaces the TPU kernel `pytorch_glow_tpu/ops/flowstep_pallas.py`
// `_make_bwd_kernel` (K3, reached through `_bwd_raw`).  Its plain PyTorch
// version is `step_backward_ref` in `pytorch_glow_tpu_torch/ops/flowstep.py`.
//
// Layout as the forward (flowstep.cu): pixel-major (M = B*H*W, C) f32 z,
// packed weights from `ops/flowstep.pack_weights(reverse=False)` with w1
// padded as the forward takes it, plus the wrapper's transposed bf16
// copies w1t (9*ch, hid), w2t (hid, hid) and w3t (hid, padded(9*cout)),
// its pad columns zero.
//
// The chain itself (recompute with conv1's staged patches, coupling and
// zero-conv cotangents, three data-gradient GEMMs, col2im and mix
// backward, three "K = M" weight-grad GEMMs, gW1 on the recompute's
// patches, column sums) is `backward_chain` in flowstep_bwd_common.cuh,
// shared with the row-band backward (flowstep_band_bwd.cu); this file runs
// it once over the whole batch.
//
// What bounds it on this card: operations.  Per step 3 * 2*M*hid*(9*ch +
// hid + 9*cout) + 12*M*C^2, about 272 GFLOP at celeba64 level 0 with b=128
// (0.27 ms at 989 TFLOP/s bf16), against about 22 MB of compulsory traffic
// (7 us at 3.35 TB/s).  All nine products run on the wgmma/TMA core of
// gemm_sm90.cuh (128 x 128 tiles, a 3-stage TMA ring, split-K over pixels
// for the weight gradients only): the recompute's three through the
// forward's own `launch_net`, so its ReLU masks are K1's bit for bit.
// Every intermediate is still staged in device memory.

#include "flowstep_bwd_common.cuh"

extern "C" {

// Bytes of scratch `glow_flowstep_bwd` needs for this shape.
size_t glow_flowstep_bwd_workspace(int affine, int b, int hh, int ww, int c, int hidden) {
  Carver cv = {nullptr, 0};
  return carve(cv, b * hh * ww, c, hidden, affine ? c : c / 2).bytes;
}

// Backward of one forward flow step.  z: (b*hh*ww, c) f32 step input;
// the 12 packed weights (w1 padded to (hidden, padded(9*ch)));
// w1t, w2t, w3t: bf16 transposes of w1, w2, w3;
// gzn: (M, c) f32 cotangent of the step output; gld: (b,) f32 cotangent
// of the per-image logdet.  Writes gz (M, c) and the 12 f32 weight grads
// (each the packed weight's shape).  Returns 0 or the first launch's
// cudaError_t.
int glow_flowstep_bwd(int affine, int b, int hh, int ww, int c, int hidden, const float* z,
                      const float* wmat, const float* anb, const float* anl, const void* w1,
                      const float* a1b, const float* a1l, const void* w2, const float* a2b,
                      const float* a2l, const void* w3, const float* b3, const float* l3,
                      const void* w1t, const void* w2t, const void* w3t, const float* gzn,
                      const float* gld, float* gz, float* g_wmat, float* g_anb, float* g_anl,
                      float* g_w1, float* g_a1b, float* g_a1l, float* g_w2, float* g_a2b,
                      float* g_a2l, float* g_w3, float* g_b3, float* g_l3, void* workspace,
                      void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = b * hh * ww;
  Carver cv = {(char*)workspace, 0};
  const Workspace ws = carve(cv, M, c, hidden, affine ? c : c / 2);
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  float* const grads[N_WEIGHTS] = {g_wmat, g_anb, g_anl, g_w1, g_a1b, g_a1l,
                                   g_w2,   g_a2b, g_a2l, g_w3, g_b3,  g_l3};
  GLOW_TRY(backward_chain<false>(affine, M, hh, ww, c, hidden, Band{}, z, sw, w1t, w2t, w3t, gzn,
                                 gld, gz, grads, ws, stream));
  return 0;
}

}  // extern "C"
