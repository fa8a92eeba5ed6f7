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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output rows (pixels) per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction slice per shared-memory stage
constexpr int GEMM_THREADS = 128;  // 4 warps, each a 32x32 sub-tile
constexpr int LDS = BK + 8;   // bf16 tile row stride (multiple of 8)
constexpr int LDC = BN + 4;   // f32 staging row stride (multiple of 4)
constexpr int ROW_THREADS = 256;

enum ALoad { A_DENSE = 0, A_CONV3X3 = 1 };
enum Epilogue { EPI_ACTNORM_RELU_BF16 = 0, EPI_F32 = 1 };

struct GemmArgs {
  int M, N, K;
  const __nv_bfloat16* a;       // A_DENSE: (M, K) row-major
  const float* z;               // A_CONV3X3: z1 = z[:, :cin], row stride ldz
  int ldz, hh, ww, cin;
  const __nv_bfloat16* w;       // (N, K) row-major
  const float* bias;            // EPI_ACTNORM_RELU_BF16: (N,)
  const float* logs;            // EPI_ACTNORM_RELU_BF16: (N,)
  __nv_bfloat16* out_bf16;      // (M, N)
  float* out_f32;               // (M, N)
};

// out[m, n] = sum_k A[m, k] * w[n, k], bf16 operands, f32 accumulation.
// A_CONV3X3 builds the im2col patch tile of z1 in shared memory: column
// k = tap * cin + ci holds z1 at the tap's neighbour, zero where the tap
// leaves the image (SAME padding, masked on (y, x) inside each image).
template <int AL, int EP>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int hw = g.hh * g.ww;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int m = m0 + r, k = k0 + kk;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (m < g.M && k < g.K) {
        if (AL == A_DENSE) {
          v = g.a[m * g.K + k];
        } else {
          const int tap = k / g.cin, ci = k - tap * g.cin;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const int img = m / hw, rem = m - img * hw;
          const int y = rem / g.ww + dy, x = rem % g.ww + dx;
          if (y >= 0 && y < g.hh && x >= 0 && x < g.ww)
            v = __float2bfloat16(g.z[(img * hw + y * g.ww + x) * g.ldz + ci]);
        }
      }
      As[r * LDS + kk] = v;
    }
    for (int idx = tid; idx < BN * BK; idx += GEMM_THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int n = n0 + r, k = k0 + kk;
      Bs[r * LDS + kk] = (n < g.N && k < g.K) ? g.w[n * g.K + k] : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.N) continue;
    float v = Cs[r * LDC + c];
    if (EP == EPI_ACTNORM_RELU_BF16) {
      v = (v + g.bias[n]) * expf(g.logs[n]);
      g.out_bf16[m * g.N + n] = __float2bfloat16(fmaxf(v, 0.0f));
    } else {
      g.out_f32[m * g.N + n] = v;
    }
  }
}

// The 1x1 channel mix in f32, one output element per thread.
//   forward: out = W @ ((z + b) * e^l)      reverse: out = (W @ z) * e^-l - b
template <bool REVERSE>
__global__ void mix_kernel(int M, int C, const float* zin, const float* w, const float* anb,
                           const float* anl, float* out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const int m = idx / C, o = idx - m * C;
  const float* row = zin + m * C;
  const float* wr = w + o * C;
  float acc = 0.0f;
  for (int i = 0; i < C; ++i) {
    float v = row[i];
    if (!REVERSE) v = (v + anb[i]) * expf(anl[i]);
    acc = fmaf(wr[i], v, acc);
  }
  if (REVERSE) acc = acc * expf(-anl[o]) - anb[o];
  out[idx] = acc;
}

// Zero-conv output channel c at pixel (py, px) of image img from the
// tap-packed y (M, 9*cout): taps summed in order k = 0..8.
__device__ __forceinline__ float zero_conv_at(const float* y, int img, int hh, int ww, int py,
                                              int px, int cout, int c, const float* b3,
                                              const float* l3) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int yy = py + k / 3 - 1, xx = px + k % 3 - 1;
    if (yy >= 0 && yy < hh && xx >= 0 && xx < ww)
      acc += y[((img * hh + yy) * ww + xx) * 9 * cout + k * cout + c];
  }
  return (acc + b3[c]) * expf(l3[c] * 3.0f);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Coupling update and per-image logdet; one block per image.  zsrc and
// zdst may alias (forward updates the mixed z in place): each element is
// read and written by the same thread only.
template <bool REVERSE, bool AFFINE>
__global__ void __launch_bounds__(ROW_THREADS)
    coupling_kernel(int hh, int ww, int C, const float* zsrc, const float* y, const float* b3,
                    const float* l3, float* zdst, float* ld) {
  __shared__ float red[ROW_THREADS];
  const int img = blockIdx.x;
  const int hw = hh * ww, ch = C / 2;
  const int cout = AFFINE ? C : ch;
  float part = 0.0f;
  for (int q = threadIdx.x; q < hw; q += ROW_THREADS) {
    const int py = q / ww, px = q - py * ww;
    const float* src = zsrc + (img * hw + q) * C;
    float* dst = zdst + (img * hw + q) * C;
    for (int j = 0; j < ch; ++j) {
      const float z1 = src[j];
      float z2 = src[ch + j];
      const float h = zero_conv_at(y, img, hh, ww, py, px, cout, j, b3, l3);
      if (AFFINE) {
        const float raw = zero_conv_at(y, img, hh, ww, py, px, cout, ch + j, b3, l3) + 2.0f;
        const float s = 1.0f / (1.0f + expf(-raw));
        z2 = REVERSE ? z2 / s - h : (z2 + h) * s;
        if (!REVERSE) part += log_sigmoid(raw);
      } else {
        z2 = REVERSE ? z2 - h : z2 + h;
      }
      dst[j] = z1;
      dst[ch + j] = z2;
    }
  }
  if (REVERSE) return;
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = ROW_THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[img] = red[0];
}

template <int AL, int EP>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  gemm_kernel<AL, EP><<<grid, GEMM_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

template <bool REVERSE>
cudaError_t launch_mix(int M, int C, const float* zin, const float* w, const float* anb,
                       const float* anl, float* out, cudaStream_t stream) {
  const int total = M * C;
  mix_kernel<REVERSE><<<(total + 255) / 256, 256, 0, stream>>>(M, C, zin, w, anb, anl, out);
  return cudaGetLastError();
}

template <bool REVERSE>
cudaError_t launch_coupling(int affine, int b, int hh, int ww, int C, const float* zsrc,
                            const float* y, const float* b3, const float* l3, float* zdst,
                            float* ld, cudaStream_t stream) {
  if (affine)
    coupling_kernel<REVERSE, true><<<b, ROW_THREADS, 0, stream>>>(hh, ww, C, zsrc, y, b3, l3,
                                                                  zdst, ld);
  else
    coupling_kernel<REVERSE, false><<<b, ROW_THREADS, 0, stream>>>(hh, ww, C, zsrc, y, b3, l3,
                                                                   zdst, ld);
  return cudaGetLastError();
}

}  // namespace

#define GLOW_TRY(expr)              \
  do {                              \
    cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

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

  GemmArgs g1 = {};
  g1.M = M; g1.N = hidden; g1.K = 9 * ch;
  g1.z = z1_src; g1.ldz = c; g1.hh = hh; g1.ww = ww; g1.cin = ch;
  g1.w = (const __nv_bfloat16*)w1; g1.bias = a1b; g1.logs = a1l;
  g1.out_bf16 = (__nv_bfloat16*)h1;
  GLOW_TRY((launch_gemm<A_CONV3X3, EPI_ACTNORM_RELU_BF16>(g1, stream)));

  GemmArgs g2 = {};
  g2.M = M; g2.N = hidden; g2.K = hidden; g2.hh = hh; g2.ww = ww;
  g2.a = (const __nv_bfloat16*)h1; g2.w = (const __nv_bfloat16*)w2;
  g2.bias = a2b; g2.logs = a2l; g2.out_bf16 = (__nv_bfloat16*)h2;
  GLOW_TRY((launch_gemm<A_DENSE, EPI_ACTNORM_RELU_BF16>(g2, stream)));

  GemmArgs g3 = {};
  g3.M = M; g3.N = 9 * cout; g3.K = hidden; g3.hh = hh; g3.ww = ww;
  g3.a = (const __nv_bfloat16*)h2; g3.w = (const __nv_bfloat16*)w3; g3.out_f32 = y;
  GLOW_TRY((launch_gemm<A_DENSE, EPI_F32>(g3, stream)));

  if (!reverse) {
    GLOW_TRY(launch_coupling<false>(affine, b, hh, ww, c, out, y, b3, l3, out, ld, stream));
  } else {
    GLOW_TRY(launch_coupling<true>(affine, b, hh, ww, c, z, y, b3, l3, tmp, ld, stream));
    GLOW_TRY(launch_mix<true>(M, c, tmp, wmat, anb, anl, out, stream));
  }
  return 0;
}

}  // extern "C"
