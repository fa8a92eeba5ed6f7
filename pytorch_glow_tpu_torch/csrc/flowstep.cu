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
// (tap, cout) and cout in [shift | raw] order; taps k = 3*dy + dx.
//
// Forward chain:
//   mix_kernel<fwd>     out = W @ ((z + b) * e^l)                      f32
//   gemm<conv3x3>       h1 = relu((conv3x3(out[:, :ch]) + b1) * e^l1)  bf16
//   gemm<dense>         h2 = relu((h1 @ w2^T + b2) * e^l2)             bf16
//   gemm<dense, f32>    y  = h2 @ w3^T   (tap-packed zero-conv, (M, 9*cout))
//   coupling_kernel     h = (sum_k y[p + off_k, k] + b3) * e^{3 l3};
//                       out[:, ch:] = (z2 + shift) * sigmoid(raw + 2), and
//                       per image sum log_sigmoid(raw + 2), one block per
//                       image in a fixed order (no atomics).
// Reverse chain: the same f(z1) on the input's z1, z2 = z2 / s - shift into
// a scratch, then mix_kernel<rev>: out = (W^-1 @ t) * e^-l - b.
// The GEMM, the mix, the zero-conv tap sum and the coupling live in
// flowstep_common.cuh, shared with the backward (flowstep_bwd.cu) and the
// anatomy variants (anatomy.cu).
//
// Every sum inside f() runs in a fixed order (the GEMM's K loop in one
// block, then taps k = 0..8), so encode and decode compute f(z1) bit for
// bit the same and decode(encode(x)) stays exact.
//
// What bounds it on this card: the two 512-wide hidden activations.  At
// celeba64 level 0 with b=64, h1 and h2 are 65,536 px x 512 x 2 B = 67 MB
// each, written and read back through device memory (plus y, 65,536 x 108
// x 4 B = 28 MB), against 34 GFLOP for the 512x512 product; the tensor
// cores would finish that product well before the ~270 MB of traffic.  This
// design keeps the intermediates in bf16 and the narrow conv3 in its
// tap-packed form to cut that traffic, and is written to be right first:
// 64x64 block tiles, bf16 wmma with f32 accumulation through shared memory,
// no software pipeline.  Keeping h1/h2 on chip in one fused kernel is the
// next step.

#include "flowstep_common.cuh"


extern "C" {

const char* glow_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One flow step.  z: (b*hh*ww, c) f32 input, left untouched.  out: (same)
// f32 result.  ld: (b,) f32 coupling logdet (forward; zeros for additive).
// h1, h2: (M, hidden) bf16 scratch; y: (M, 9*cout) f32 scratch; tmp: (M, c)
// f32 scratch (reverse only).  Returns 0 or the first launch's cudaError_t.
int glow_flowstep(int reverse, int affine, int b, int hh, int ww, int c, int hidden,
                  const float* z, const float* wmat, const float* anb, const float* anl,
                  const void* w1, const float* a1b, const float* a1l, const void* w2,
                  const float* a2b, const float* a2l, const void* w3, const float* b3,
                  const float* l3, float* out, float* ld, void* h1, void* h2, float* y,
                  float* tmp, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = b * hh * ww, ch = c / 2;
  const int cout = affine ? c : ch;
  const float* z1_src = z;
  if (!reverse) {
    GLOW_TRY(launch_mix<false>(M, c, z, wmat, anb, anl, out, stream));
    z1_src = out;
  }

  GLOW_TRY(launch_net(M, hh, ww, c, hidden, cout, z1_src, w1, a1b, a1l, w2, a2b, a2l, w3,
                      h1, h2, y, stream));

  if (!reverse) {
    GLOW_TRY(launch_coupling<false>(affine, b, hh, ww, c, out, y, b3, l3, out, ld, stream));
  } else {
    GLOW_TRY(launch_coupling<true>(affine, b, hh, ww, c, z, y, b3, l3, tmp, ld, stream));
    GLOW_TRY(launch_mix<true>(M, c, tmp, wmat, anb, anl, out, stream));
  }
  return 0;
}

}  // extern "C"
