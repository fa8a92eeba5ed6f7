// The wgmma/TMA GEMM core of gemm_sm90.cuh on its own, as the flow-step
// chains call it, for checking it against a plain product on the card
// (`ops/flowstep.gemm_core`, chip_smoke.py).  It replaces no TPU kernel by
// itself: it is the core of K1-K5 (the coupling net's products in
// flowstep_common.cuh `launch_net`, the gradient products in
// flowstep_bwd_common.cuh `backward_chain`).

#include "flowstep_bwd_common.cuh"

extern "C" {

// Bytes of f32 partials `glow_gemm_sm90` needs for a weight-gradient
// product (trans) of (m, n) over k pixels; 0 for a data-gradient one.
size_t glow_gemm_sm90_workspace(int trans, int m, int n, int k) {
  if (!trans) return 0;
  const int chunk = sm90::wgrad_chunk(k, m, n);
  return (size_t)sm90::chunk_count(k, chunk, 0) * m * n * 4;
}

// out (m, n) f32 from bf16 a and b, row strides lda and ldb elements:
//   trans = 0: out = a (m, k) . b (n, k)^T      (the data gradients' order)
//   trans = 1: out = a (k, m)^T . b (k, n)      (the weight gradients': one
//              partial per pixel chunk into `workspace`, summed in order)
// Returns 0 or the first failing call's cudaError_t.
int glow_gemm_sm90(int trans, int m, int n, int k, const void* a, int lda, const void* b,
                   int ldb, float* out, void* workspace, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (trans)
    return (int)weight_grad<true>(k, m, n, a, lda, b, ldb, 0, (float*)workspace, out, stream);
  sm90::Args g = {};
  g.M = m;
  g.N = n;
  g.K = k;
  g.out_f32 = out;
  return (int)sm90::gemm_nt<sm90::EPI_F32>(g, a, lda, b, ldb, stream);
}

// out (m, n) bf16 = relu((a (m, k) . b (n, k)^T + bias) * e^logs), the
// coupling net's conv epilogue (bias, logs: (n,) f32; n a multiple of 8).
// Returns 0 or the first failing call's cudaError_t.
int glow_gemm_sm90_actnorm_relu(int m, int n, int k, const void* a, int lda, const void* b,
                                int ldb, const float* bias, const float* logs, void* out,
                                void* stream_ptr) {
  sm90::Args g = {};
  g.M = m;
  g.N = n;
  g.K = k;
  g.bias = bias;
  g.logs = logs;
  g.out_bf16 = (__nv_bfloat16*)out;
  return (int)sm90::gemm_nt<sm90::EPI_ACTNORM_RELU_BF16>(g, a, lda, b, ldb,
                                                         (cudaStream_t)stream_ptr);
}

}  // extern "C"
