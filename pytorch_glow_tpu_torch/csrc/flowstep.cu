// One Glow flow step, forward and reverse, as a short chain of hand-written
// kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel `pytorch_glow_tpu/ops/flowstep_pallas.py`
// `_make_kernel` (reverse=False: K1, reverse=True: K2).  Its plain PyTorch
// version is `step_forward_ref` / `step_reverse_ref` in
// `pytorch_glow_tpu_torch/ops/flowstep.py`.
//
// Layout: pixel-major, z is (M = B*H*W, C) f32 with images contiguous (the
// NHWC tensor itself).  Weights come packed by `ops/flowstep.pack_weights`:
// the f32 mix W (C, C), actnorm columns, bf16 w1 (hid, 9*ch) with columns
// (tap, cin), bf16 w2 (hid, hid), bf16 w3 (9*cout, hid) with rows
// (tap, cout) and cout in [shift | raw] order; taps k = 3*dy + dx.  The
// wrapper passes w1 with its rows padded to padded(9*ch) columns
// (`ops/flowstep.padded_w1`), as the GEMM core's TMA reads it.
//
// Forward chain (`launch_net` and the rest in flowstep_common.cuh, shared
// with the backward's recompute, the band chain and the anatomy variants):
//   mix_tile_kernel<fwd>  out = W @ ((z + b) * e^l), a tiled f32 product
//                         on the CUDA cores                             f32
//   stage_patches_kernel  p1 = conv1's 3x3 patches of out[:, :ch], masked,
//                         (M, padded(9*ch))                             bf16
//   gemm_nt<actnorm-relu> h1 = relu((p1 @ w1^T + b1) * e^l1)            bf16
//   gemm_nt<actnorm-relu> h2 = relu((h1 @ w2^T + b2) * e^l2)            bf16
//   gemm_nt<f32>          y  = h2 @ w3^T (tap-packed zero-conv, (M, 9*cout))
//   coupling_update_kernel  per (pixel, channel): h = (sum_k y[p + off_k, k]
//                         + b3) * e^{3 l3}; out[:, ch:] = (z2 + shift) *
//                         sigmoid(raw + 2), and per block of pixels a
//                         partial sum of log_sigmoid(raw + 2)
//   ld_sum_kernel         each image's partials summed in order (no atomics).
// Reverse chain: the same f(z1) on the input's z1, z2 = z2 / s - shift into
// a scratch, then mix_tile_kernel<rev>: out = (W^-1 @ t) * e^-l - b.  The
// three products run on the wgmma/TMA core of gemm_sm90.cuh (128 x 128
// tiles, a 3-stage TMA ring, two consumer warpgroups), the actnorm and
// ReLU in its epilogue.
//
// Every sum inside f() runs in a fixed order (each product's K slices in
// one block, in order, no split-K; then taps k = 0..8), so encode and
// decode compute f(z1) bit for bit the same and decode(encode(x)) stays
// exact.
//
// What bounds it on this card: operations.  At celeba64 level 0 with b=64
// the net is 2 * 65,536 px * 512 * (54 + 512 + 108) = 45 GFLOP (46 us at
// 989 TFLOP/s) against 2 * 3.1 MB of z in and out.  This chain stages
// p1 (7 MB), h1 and h2 (65,536 x 512 x 2 B = 67 MB each) and y (28 MB) in
// device memory, each written once and read back, about 0.34 GB (0.1 ms
// at 3.35 TB/s), so it sits above the bound by that traffic and by how far
// the core's products run below the tensor cores' rate.  Keeping h1/h2 on
// chip in one fused kernel, and gathering conv1's patches in the core's
// producer, are the next steps.

#include "flowstep_common.cuh"


extern "C" {

const char* glow_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One flow step.  z: (b*hh*ww, c) f32 input, left untouched.  out: (same)
// f32 result.  ld: (b,) f32 coupling logdet (forward; zeros for additive).
// w1 padded to (hidden, padded(9*ch)).  p1: (M, padded(9*ch)) bf16, h1, h2:
// (M, hidden) bf16, y: (M, 9*cout) f32, tmp: (M, c) f32 (reverse only)
// scratch.  Returns 0 or the first launch's cudaError_t.
int glow_flowstep(int reverse, int affine, int b, int hh, int ww, int c, int hidden,
                  const float* z, const float* wmat, const float* anb, const float* anl,
                  const void* w1, const float* a1b, const float* a1l, const void* w2,
                  const float* a2b, const float* a2l, const void* w3, const float* b3,
                  const float* l3, float* out, float* ld, void* p1, void* h1, void* h2,
                  float* y, float* tmp, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = b * hh * ww, ch = c / 2;
  const int cout = affine ? c : ch;
  const float* z1_src = z;
  if (!reverse) {
    GLOW_TRY(launch_mix<false>(M, c, z, wmat, anb, anl, out, stream));
    z1_src = out;
  }

  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  GLOW_TRY(launch_net(M, hh, ww, c, hidden, cout, z1_src, sw, p1, h1, h2, y, stream));

  if (!reverse) {
    // The logdet partials go to h1's storage, which conv2 has read.
    GLOW_TRY((launch_coupling<false, false>(affine, b, hh, ww, c, Band{}, out, y, b3, l3, out, ld,
                                            (float*)h1, stream)));
  } else {
    GLOW_TRY((launch_coupling<false, true>(affine, b, hh, ww, c, Band{}, z, y, b3, l3, tmp, nullptr,
                                           nullptr, stream)));
    GLOW_TRY(launch_mix<true>(M, c, tmp, wmat, anb, anl, out, stream));
  }
  return 0;
}

}  // extern "C"
