// The LU-parameterised invertible 1x1 convolution as hand-written kernels
// for Hopper (sm_90a): the weight build and the channel mix over a pixel
// batch, both in plain f32 on the CUDA cores.
//
// Replaces the TPU kernels of `pytorch_glow_tpu/ops/invconv_pallas.py`:
//   * K6a, `_pallas_fused_raw` (body `_fwd_kernel`): builds
//     W = P L (U + diag(sign_s e^log_s)) once into VMEM scratch in grid
//     step 0, then y = x W^T over 1024-row tiles.  On Hopper blocks run in
//     no order, so "step 0 first" becomes two launches on one stream:
//     `build_kernel` writes W (C, C) f32 into a scratch the wrapper
//     allocates, then `mix_kernel` reads it.
//   * K6b, `_pallas_plain_raw` (body `_matmul_kernel`): y = x W^-T with
//     W^-1 from two triangular solves outside the kernel; the same
//     `mix_kernel` alone.
// Their plain PyTorch versions are `lu_assemble`, `lu_inverse` and
// `mix_channels` in `pytorch_glow_tpu_torch/ops/invconv.py`; the wrappers
// are `pytorch_glow_tpu_torch/ops/invconv_fused.py`.
//
// Precision: the TPU kernel multiplies at HIGHEST, and the exact round-trip
// and the NLL depend on the mix, so every product here is an f32 FMA on
// the CUDA cores, summed in ascending input-channel order.  No TF32, no
// tensor cores.
//
// What bounds it on this card: max(4 (2NC + C^2) B / 3.35 TB/s,
// 2NC^2 / 67 TFLOP/s).  At C <= 48 (every cifar10 level) the bytes bound
// it: x is read once and y written once, 0.5 C FLOP per byte.  At the
// widths where the f32 FMAs would bound it (C >= ~140) N is small.  The
// design is a simple tiled SGEMM: 64x64 output tiles, x and W staged in
// shared memory 16 input channels at a time with coalesced loads, 4x4
// outputs per thread in registers; the ragged row, column and channel
// edges load zeros (adding an exact zero changes no sum).  At small C most
// of a tile's columns are masked, and the launch itself dominates; a
// narrower tile or 3xTF32 on wgmma at large C is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;   // rows (pixels) per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels staged per pass
constexpr int TX = 16;   // threads along the output channels
constexpr int TY = 16;   // threads along the rows
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;  // rows per thread
constexpr int RN = BN / TX;  // output channels per thread
constexpr int BUILD_THREADS = 256;

// W[i, j] = sum_k L[p[i], k] U'[k, j], L unit lower, U' = triu(U, 1) +
// diag(sign e^log_s); one thread per element, k ascending.
__global__ void __launch_bounds__(BUILD_THREADS)
    build_kernel(int C, const int64_t* __restrict__ p_idx, const float* __restrict__ l_raw,
                 const float* __restrict__ u_raw, const float* __restrict__ log_s,
                 const float* __restrict__ sign_s, float* __restrict__ w) {
  const int64_t e = (int64_t)blockIdx.x * BUILD_THREADS + threadIdx.x;
  if (e >= (int64_t)C * C) return;
  const int i = (int)(e / C), j = (int)(e % C);
  const int r = (int)p_idx[i];
  const float* lrow = l_raw + (int64_t)r * C;
  const int kmax = r < j ? r : j;
  float acc = 0.0f;
  for (int k = 0; k <= kmax; ++k) {
    const float l = k == r ? 1.0f : lrow[k];
    const float u = k == j ? sign_s[j] * expf(log_s[j]) : u_raw[(int64_t)k * C + j];
    acc = fmaf(l, u, acc);
  }
  w[e] = acc;
}

// y[n, j] = sum_i x[n, i] w[j, i]; x (N, C), w (C, C), y (N, C), all f32
// row-major.  Block (blockIdx.x, blockIdx.y) owns rows [64 bx, +64) and
// output channels [64 by, +64).
__global__ void __launch_bounds__(THREADS)
    mix_kernel(int N, int C, const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y) {
  // Padded by one so the transposing stores spread over the banks.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  // Loader coordinates: 16 neighbouring threads read 16 neighbouring
  // channels of one row.
  const int lk = threadIdx.x % BK, lr = threadIdx.x / BK;  // lr in [0, 16)

  float acc[RM][RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    const int k = k0 + lk;
#pragma unroll
    for (int q = 0; q < BM / (THREADS / BK); ++q) {
      const int r = lr + q * (THREADS / BK);
      const int64_t n = row0 + r;
      xs[lk][r] = (n < N && k < C) ? x[n * C + k] : 0.0f;
      const int j = col0 + r;
      ws[lk][r] = (j < C && k < C) ? w[(int64_t)j * C + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xv[RM], wv[RN];
#pragma unroll
      for (int a = 0; a < RM; ++a) xv[a] = xs[kk][ty + a * TY];
#pragma unroll
      for (int b = 0; b < RN; ++b) wv[b] = ws[kk][tx + b * TX];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < RN; ++b) acc[a][b] = fmaf(xv[a], wv[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int64_t n = row0 + ty + a * TY;
    if (n >= N) continue;
#pragma unroll
    for (int b = 0; b < RN; ++b) {
      const int j = col0 + tx + b * TX;
      if (j < C) y[n * C + j] = acc[a][b];
    }
  }
}

cudaError_t launch_mix(int n, int c, const float* x, const float* w, float* y,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)((c + BN - 1) / BN));
  mix_kernel<<<grid, THREADS, 0, stream>>>(n, c, x, w, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6a.  x, y: (n, c) f32; p_idx (c,) int64; l_raw, u_raw (c, c) f32 (only
// the strict lower / upper parts are read); log_s, sign_s (c,) f32;
// w: (c, c) f32 scratch that receives W.  Returns 0 or the first launch's
// cudaError_t.
int glow_invconv_forward(int n, int c, const float* x, const int64_t* p_idx,
                         const float* l_raw, const float* u_raw, const float* log_s,
                         const float* sign_s, float* w, float* y, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t elems = (int64_t)c * c;
  build_kernel<<<(unsigned)((elems + BUILD_THREADS - 1) / BUILD_THREADS), BUILD_THREADS, 0,
                 stream>>>(c, p_idx, l_raw, u_raw, log_s, sign_s, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_mix(n, c, x, w, y, stream);
}

// K6b.  x, y: (n, c) f32; w: (c, c) f32 (W^-1).  y = x w^T.
int glow_invconv_mix(int n, int c, const float* x, const float* w, float* y,
                     void* stream_ptr) {
  return (int)launch_mix(n, c, x, w, y, (cudaStream_t)stream_ptr);
}

}  // extern "C"
