// Kernels shared by the flow step's forward/reverse chain (flowstep.cu), its
// backward (flowstep_bwd.cu) and their row-band variants (flowstep_band.cu,
// flowstep_band_bwd.cu): the bf16 wmma GEMM with its operand loaders and
// epilogues, the f32 channel mix, the zero-conv tap sum, and the row-band
// geometry with its gather.
//
// Every translation unit compiles this same code with the same flags, so
// the backward's recompute of h1, h2 and y is bit for bit the forward's,
// and a band's centre rows are bit for bit the whole chain's.
//
// The template parameters `Tap` and `Form`, and the gemm's ROWSUM and the
// mix's SPLIT, select the anatomy studies' variants (csrc/anatomy.cu);
// their defaults are the production kernels, the only ones the other
// translation units instantiate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output rows (pixels) per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction slice per shared-memory stage
constexpr int GEMM_THREADS = 128;  // 4 warps, each a 32x32 sub-tile
constexpr int LDS = BK + 8;   // bf16 tile row stride (multiple of 8)
constexpr int LDC = BN + 4;   // f32 staging row stride (multiple of 4)
constexpr int ROW_THREADS = 256;

enum ALoad { A_DENSE = 0, A_CONV3X3 = 1, A_CONV3X3_BAND = 2 };
enum Epilogue { EPI_ACTNORM_RELU_BF16 = 0, EPI_F32 = 1, EPI_RELU_GRAD_BF16 = 2 };

// How a 3x3 tap k of pixel m reads its neighbour at flattened offset
// off_k = (dy - 1) * ww + (dx - 1).  Production masks; the anatomy
// variants drop the border test or the shift.
enum Tap {
  TAP_MASKED = 0,         // the neighbour, zero where it leaves the image
  TAP_WRAP = 1,           // pixel (m + off_k) mod M, no border test
  TAP_CENTRE = 2,         // pixel m, no border test
  TAP_CENTRE_MASKED = 3,  // pixel m, zero where the neighbour leaves the image
};

// The coupling update: production, or one anatomy variant of it.
enum Form {
  FORM_PROD = 0,       // forward (z2 + shift) * s and the logdet; reverse z2 / s - shift
  FORM_NO_LOGDET = 1,  // forward without the logdet: ld = 0
  FORM_RECIP_EXP = 2,  // reverse z2 * (1 + e^-(raw + 2)) - shift (1/sigmoid, same math)
  FORM_NO_DIV = 3,     // reverse z2 * s - shift (drops the divide; wrong math)
  FORM_SPLIT = 4,      // reverse, writes only z2' into an (M, C/2) buffer
};

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Row-band geometry.  A band launch stages `count` consecutive bands of R
// rows, each extended by a 2-row halo above and below (the coupling net's
// receptive field) into an (R+4)-row "image" of the staging buffers.  Band
// j of the launch is band first + j of the batch: image (first + j) / T,
// absolute first row ((first + j) % T) * R - 2, of an image `height` rows
// high.  Taps are masked on absolute rows, so halo rows outside the image
// (above row 0, below the last row) read as zero.
struct Band {
  int first, per_image, rows, height;  // first band, T, R, true image height
};

// Whether local row yy of staged image img lies inside the true image:
// always for whole images; for a band, when its absolute row is in
// [0, height).
template <bool BAND>
__device__ __forceinline__ bool row_in_image(const Band& bd, int img, int yy) {
  if (!BAND) return true;
  const int row = ((bd.first + img) % bd.per_image) * bd.rows - 2 + yy;
  return row >= 0 && row < bd.height;
}

struct GemmArgs {
  int M, N, K;
  const __nv_bfloat16* a;       // A_DENSE: (M, K) row-major
  const float* z;               // A_CONV3X3: z1 = z[:, :cin], row stride ldz
  int ldz, hh, ww, cin;
  const __nv_bfloat16* w;       // (N, K) row-major
  const float* bias;            // EPI_ACTNORM_RELU_BF16: (N,)
  const float* logs;            // EPI_ACTNORM_RELU_BF16, EPI_RELU_GRAD_BF16: (N,)
  const __nv_bfloat16* h;       // EPI_RELU_GRAD_BF16: the ReLU output (M, N)
  __nv_bfloat16* out_bf16;      // (M, N)
  float* out_f32;               // (M, N)
  float* part_b;                // EPI_RELU_GRAD_BF16: (M / BM blocks, N) partials
  float* part_l;                //   of sum g_a and of sum g_an * h
  Band band;                    // A_CONV3X3_BAND: hh is the staged R + 4 rows
};

// Patch element k = tap * cin + ci of pixel m: z1 at the tap's neighbour,
// zero where the tap leaves the image (SAME padding, masked on (y, x)
// inside each image, and for a band on the absolute row).  Taps
// k = 3*dy + dx, neighbour (y + dy - 1, x + dx - 1).  `total` (the pixel
// count M) is read by TAP_WRAP only.
template <bool BAND, int TAP = TAP_MASKED>
__device__ __forceinline__ __nv_bfloat16 conv3x3_patch(const float* z, int ldz, int hh, int ww,
                                                       int cin, int m, int k, const Band& bd,
                                                       int total = 0) {
  static_assert(TAP != TAP_CENTRE_MASKED, "no variant reads masked centre patches");
  static_assert(TAP == TAP_MASKED || !BAND, "no band variants");
  const int hw = hh * ww;
  const int tap = k / cin, ci = k - tap * cin;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  if constexpr (TAP == TAP_WRAP) {
    return __float2bfloat16(z[wrap_index(m + dy * ww + dx, total) * ldz + ci]);
  } else if constexpr (TAP == TAP_CENTRE) {
    return __float2bfloat16(z[m * ldz + ci]);
  }
  const int img = m / hw, rem = m - img * hw;
  const int y = rem / ww + dy, x = rem % ww + dx;
  if (y >= 0 && y < hh && x >= 0 && x < ww && row_in_image<BAND>(bd, img, y))
    return __float2bfloat16(z[(img * hw + y * ww + x) * ldz + ci]);
  return __float2bfloat16(0.0f);
}

// out[m, n] = sum_k A[m, k] * w[n, k], bf16 operands, f32 accumulation.
// A_CONV3X3 builds the im2col patch tile of z1 in shared memory, its taps
// read as TAP says.  Without ROWSUM, EPI_RELU_GRAD_BF16 writes no block
// partials.
template <int AL, int EP, int TAP = TAP_MASKED, bool ROWSUM = true>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

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
        if (AL == A_DENSE)
          v = g.a[m * g.K + k];
        else
          v = conv3x3_patch<AL == A_CONV3X3_BAND, TAP>(g.z, g.ldz, g.hh, g.ww, g.cin, m, k,
                                                        g.band, g.M);
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
    } else if (EP == EPI_RELU_GRAD_BF16) {
      // v is the cotangent of h = relu((a + b) * e^l): g_an = v where h > 0,
      // g_a = g_an * e^l, stored in bf16 for the next GEMMs.
      const float gn = __bfloat162float(g.h[m * g.N + n]) > 0.0f ? v : 0.0f;
      g.out_bf16[m * g.N + n] = __float2bfloat16(gn * expf(g.logs[n]));
    } else {
      g.out_f32[m * g.N + n] = v;
    }
  }

  if (EP == EPI_RELU_GRAD_BF16 && ROWSUM && tid < 2 * BN) {
    // Block partials over this block's rows, in row order: thread c sums
    // g_a of column c, thread BN + c sums g_an * h (a_n == h where the
    // ReLU passes).  f32, before the bf16 cast, as the reference sums.
    const int c = tid % BN, n = n0 + c;
    if (n < g.N) {
      const float el = expf(g.logs[n]);
      float s = 0.0f;
      for (int r = 0; r < BM && m0 + r < g.M; ++r) {
        const float hv = __bfloat162float(g.h[(m0 + r) * g.N + n]);
        const float gn = hv > 0.0f ? Cs[r * LDC + c] : 0.0f;
        s += tid < BN ? gn * el : gn * hv;
      }
      (tid < BN ? g.part_b : g.part_l)[blockIdx.x * g.N + n] = s;
    }
  }
}

// The 1x1 channel mix in f32, one output element per thread.
//   forward: out = W @ ((z + b) * e^l)      reverse: out = (W @ z) * e^-l - b
// With SPLIT, inputs C/2.. come from z2 (M, C/2) instead of zin.
template <bool REVERSE, bool SPLIT = false>
__global__ void mix_kernel(int M, int C, const float* zin, const float* w, const float* anb,
                           const float* anl, float* out, const float* z2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const int m = idx / C, o = idx - m * C;
  const float* row = zin + m * C;
  const float* wr = w + o * C;
  float acc = 0.0f;
  for (int i = 0; i < C; ++i) {
    float v;
    if constexpr (SPLIT)
      v = i < C / 2 ? row[i] : z2[m * (C / 2) + i - C / 2];
    else
      v = row[i];
    if (!REVERSE) v = (v + anb[i]) * expf(anl[i]);
    acc = fmaf(wr[i], v, acc);
  }
  if (REVERSE) acc = acc * expf(-anl[o]) - anb[o];
  out[idx] = acc;
}

// Zero-conv output channel c at pixel (py, px) of image img from the
// tap-packed y (M, 9*cout): taps summed in order k = 0..8, masked as the
// conv1 patches are, or read as TAP says (`total`, the pixel count M, for
// TAP_WRAP).
template <bool BAND, int TAP = TAP_MASKED>
__device__ __forceinline__ float zero_conv_at(const float* y, int img, int hh, int ww, int py,
                                              int px, int cout, int c, const float* b3,
                                              const float* l3, const Band& bd, int total = 0) {
  float acc = 0.0f;
  if constexpr (TAP != TAP_MASKED) {
    static_assert(!BAND, "no band variants");
    const int m = (img * hh + py) * ww + px;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dy = k / 3 - 1, dx = k % 3 - 1;
      if (TAP == TAP_WRAP)
        acc += y[wrap_index(m + dy * ww + dx, total) * 9 * cout + k * cout + c];
      else if (TAP == TAP_CENTRE ||
               (py + dy >= 0 && py + dy < hh && px + dx >= 0 && px + dx < ww))
        acc += y[m * 9 * cout + k * cout + c];
    }
    return (acc + b3[c]) * expf(l3[c] * 3.0f);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int yy = py + k / 3 - 1, xx = px + k % 3 - 1;
    if (yy >= 0 && yy < hh && xx >= 0 && xx < ww && row_in_image<BAND>(bd, img, yy))
      acc += y[((img * hh + yy) * ww + xx) * 9 * cout + k * cout + c];
  }
  return (acc + b3[c]) * expf(l3[c] * 3.0f);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

template <int AL, int EP, int TAP = TAP_MASKED, bool ROWSUM = true>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  gemm_kernel<AL, EP, TAP, ROWSUM><<<grid, GEMM_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

template <bool REVERSE, bool SPLIT = false>
cudaError_t launch_mix(int M, int C, const float* zin, const float* w, const float* anb,
                       const float* anl, float* out, cudaStream_t stream,
                       const float* z2 = nullptr) {
  const int total = M * C;
  mix_kernel<REVERSE, SPLIT><<<(total + 255) / 256, 256, 0, stream>>>(M, C, zin, w, anb, anl,
                                                                     out, z2);
  return cudaGetLastError();
}

// f() of the coupling from the mixed z: h1, h2 (bf16) and the tap-packed
// zero-conv product y (f32), the same three launches in both directions
// and in the backward's recompute; with BAND, over staged row bands.
// Anatomy variants: TAP for conv1's patch taps, or with STAGED a dense
// (M, 9*ch) bf16 patch tensor `patches` read as it is.
template <bool BAND = false, int TAP = TAP_MASKED, bool STAGED = false>
inline cudaError_t launch_net(int M, int hh, int ww, int c, int hidden, int cout,
                              const float* z1_src, const void* w1, const float* a1b,
                              const float* a1l, const void* w2, const float* a2b,
                              const float* a2l, const void* w3, void* h1, void* h2, float* y,
                              cudaStream_t stream, Band bd = Band{},
                              const void* patches = nullptr) {
  const int ch = c / 2;
  GemmArgs g1 = {};
  g1.M = M; g1.N = hidden; g1.K = 9 * ch;
  g1.z = z1_src; g1.ldz = c; g1.hh = hh; g1.ww = ww; g1.cin = ch;
  g1.w = (const __nv_bfloat16*)w1; g1.bias = a1b; g1.logs = a1l;
  g1.out_bf16 = (__nv_bfloat16*)h1; g1.band = bd;
  cudaError_t err;
  if constexpr (STAGED) {
    g1.a = (const __nv_bfloat16*)patches;
    err = launch_gemm<A_DENSE, EPI_ACTNORM_RELU_BF16>(g1, stream);
  } else {
    err = launch_gemm<BAND ? A_CONV3X3_BAND : A_CONV3X3, EPI_ACTNORM_RELU_BF16, TAP>(g1, stream);
  }
  if (err != cudaSuccess) return err;

  GemmArgs g2 = {};
  g2.M = M; g2.N = hidden; g2.K = hidden; g2.hh = hh; g2.ww = ww;
  g2.a = (const __nv_bfloat16*)h1; g2.w = (const __nv_bfloat16*)w2;
  g2.bias = a2b; g2.logs = a2l; g2.out_bf16 = (__nv_bfloat16*)h2;
  err = launch_gemm<A_DENSE, EPI_ACTNORM_RELU_BF16>(g2, stream);
  if (err != cudaSuccess) return err;

  GemmArgs g3 = {};
  g3.M = M; g3.N = 9 * cout; g3.K = hidden; g3.hh = hh; g3.ww = ww;
  g3.a = (const __nv_bfloat16*)h2; g3.w = (const __nv_bfloat16*)w3; g3.out_f32 = y;
  return launch_gemm<A_DENSE, EPI_F32>(g3, stream);
}

// Coupling update and per-image logdet; one block per image.  zsrc and
// zdst may alias (forward updates the mixed z in place): each element is
// read and written by the same thread only.  Anatomy variants: TAP for the
// zero-conv's taps, FORM for the update (FORM_SPLIT writes z2' alone into
// zdst, an (M, C/2) buffer).
template <bool REVERSE, bool AFFINE, int TAP = TAP_MASKED, int FORM = FORM_PROD>
__global__ void __launch_bounds__(ROW_THREADS)
    coupling_kernel(int hh, int ww, int C, const float* zsrc, const float* y, const float* b3,
                    const float* l3, float* zdst, float* ld) {
  __shared__ float red[ROW_THREADS];
  const int img = blockIdx.x;
  const int hw = hh * ww, ch = C / 2;
  const int cout = AFFINE ? C : ch;
  const int total = TAP == TAP_WRAP ? (int)gridDim.x * hw : 0;
  float part = 0.0f;
  for (int q = threadIdx.x; q < hw; q += ROW_THREADS) {
    const int py = q / ww, px = q - py * ww;
    const float* src = zsrc + (img * hw + q) * C;
    float* dst = zdst + (img * hw + q) * C;
    for (int j = 0; j < ch; ++j) {
      const float z1 = src[j];
      float z2 = src[ch + j];
      const float h =
          zero_conv_at<false, TAP>(y, img, hh, ww, py, px, cout, j, b3, l3, Band{}, total);
      if (AFFINE) {
        const float raw = zero_conv_at<false, TAP>(y, img, hh, ww, py, px, cout, ch + j, b3, l3,
                                                   Band{}, total) + 2.0f;
        const float s = 1.0f / (1.0f + expf(-raw));
        if constexpr (FORM == FORM_RECIP_EXP)
          z2 = z2 * (1.0f + expf(-raw)) - h;
        else if constexpr (FORM == FORM_NO_DIV)
          z2 = z2 * s - h;
        else
          z2 = REVERSE ? z2 / s - h : (z2 + h) * s;
        if (!REVERSE && FORM != FORM_NO_LOGDET) part += log_sigmoid(raw);
      } else {
        z2 = REVERSE ? z2 - h : z2 + h;
      }
      if constexpr (FORM == FORM_SPLIT) {
        zdst[(img * hw + q) * ch + j] = z2;
      } else {
        dst[j] = z1;
        dst[ch + j] = z2;
      }
    }
  }
  if (REVERSE) return;
  if constexpr (FORM == FORM_NO_LOGDET) {
    if (threadIdx.x == 0) ld[img] = 0.0f;
    return;
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = ROW_THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[img] = red[0];
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

// Stage `count` bands of the batch (b, height, ww, c) f32 into ext
// (count * (R+4) * ww, c): rows outside the image are zero, and with
// CENTRE_ONLY the halo rows too (a cotangent that belongs to the
// neighbouring bands).  Global offsets in 64 bits.
template <bool CENTRE_ONLY>
__global__ void gather_band_kernel(int count, int ww, int c, Band bd, const float* src,
                                   float* ext) {
  const int ext_rows = bd.rows + 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count * ext_rows * ww * c) return;
  const int ch = idx % c, px = idx / c;
  const int x = px % ww, r = px / ww;
  const int j = r / ext_rows, yy = r - j * ext_rows;
  const int band = bd.first + j;
  const int img = band / bd.per_image;
  const int row = (band % bd.per_image) * bd.rows - 2 + yy;
  const bool keep = row >= 0 && row < bd.height && (!CENTRE_ONLY || (yy >= 2 && yy < bd.rows + 2));
  ext[idx] = keep ? src[(((size_t)img * bd.height + row) * ww + x) * c + ch] : 0.0f;
}

template <bool CENTRE_ONLY>
cudaError_t gather_band(int count, int ww, int c, const Band& bd, const float* src, float* ext,
                        cudaStream_t stream) {
  const int total = count * (bd.rows + 4) * ww * c;
  gather_band_kernel<CENTRE_ONLY><<<(total + 255) / 256, 256, 0, stream>>>(count, ww, c, bd, src,
                                                                           ext);
  return cudaGetLastError();
}

}  // namespace

// In a C entry (returns int) and in a chain helper (returns cudaError_t):
// return the first failing launch's error.
#define GLOW_TRY(expr)              \
  do {                              \
    cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
#define GLOW_CHECK(expr)            \
  do {                              \
    cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)
