// Kernels shared by the flow step's forward/reverse chain (flowstep.cu), its
// backward (flowstep_bwd.cu) and their row-band variants (flowstep_band.cu,
// flowstep_band_bwd.cu): the coupling net on the wgmma/TMA GEMM core
// (gemm_sm90.cuh) with conv1's patch staging, the f32 channel mix, the
// zero-conv tap sum, the coupling update, and the row-band geometry with
// its gather.
//
// Every translation unit compiles this same code with the same flags, so
// the backward's recompute of p1, h1, h2 and y is bit for bit the
// forward's, and a band's centre rows are bit for bit the whole chain's.
//
// The template parameters `Tap` and `Form`, the net's STAGED and the mix's
// SPLIT select the anatomy studies' variants (csrc/anatomy.cu); their
// defaults are the production kernels, the only ones the other
// translation units instantiate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"

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

namespace {

constexpr int ROW_THREADS = 256;

__host__ __device__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Columns of a bf16 buffer the GEMM core reads through TMA: a multiple of
// 8, so that its rows are a multiple of 16 bytes apart.
__host__ __device__ int padded(int n) { return ceil_div(n, 8) * 8; }

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
// first row ((first + j) % T) * R - 2 relative to the first centre row.
// The input holds `stored` rows per image, its first centre row at stored
// row `lead`; that row is absolute row `origin` of an image `image` rows
// high.  Whole images: lead 0, origin 0, stored = image = hh.  A row slab
// of an image split over ranks (the slab form): the slab's S rows with
// `lead` = 2 rows of each neighbour around them (stored = S + 4), origin
// its first row in the image.  Taps are masked on absolute rows, so halo
// rows outside the image (above row 0, below the last row) read as zero,
// whatever the input holds there.
struct Band {
  int first, per_image, rows;  // first band of the launch, T, R
  int stored, lead;            // input rows per image, rows before the first centre row
  int origin, image;           // absolute row of the first centre row, true image height
};

// Whether local row yy of staged image img lies inside the true image:
// always for whole images; for a band, when its absolute row is in
// [0, image).
template <bool BAND>
__device__ __forceinline__ bool row_in_image(const Band& bd, int img, int yy) {
  if (!BAND) return true;
  const int row = bd.origin + ((bd.first + img) % bd.per_image) * bd.rows - 2 + yy;
  return row >= 0 && row < bd.image;
}

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

template <bool REVERSE, bool SPLIT = false>
cudaError_t launch_mix(int M, int C, const float* zin, const float* w, const float* anb,
                       const float* anl, float* out, cudaStream_t stream,
                       const float* z2 = nullptr) {
  const int total = M * C;
  mix_kernel<REVERSE, SPLIT><<<(total + 255) / 256, 256, 0, stream>>>(M, C, zin, w, anb, anl,
                                                                     out, z2);
  return cudaGetLastError();
}

// The 12 packed weights in `pack_weights` order, as the C entries take
// them; w1 with its rows padded to padded(9*ch) columns, the pad zero (the
// wrapper's copy: the core's TMA reads 16-byte row strides).
struct StepWeights {
  const float *wmat, *anb, *anl;
  const void* w1;
  const float *a1b, *a1l;
  const void* w2;
  const float *a2b, *a2l;
  const void* w3;
  const float *b3, *l3;
};

// Conv1's patches p1 (M, padded(9*ch)) in bf16, the pad zero: element
// k = tap * ch + ci of pixel m is `conv3x3_patch` of z1 = z[:, :ch] (masked
// on absolute rows for a band, or read as TAP says).  The conv1 product
// reads it as its dense A operand, the backward's gW1 product the
// recompute's.
template <bool BAND, int TAP = TAP_MASKED>
__global__ void stage_patches_kernel(int M, int hh, int ww, int c, const float* z,
                                     __nv_bfloat16* p1, Band bd) {
  const int ch = c / 2, ld = padded(9 * ch);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * ld) return;
  const int m = idx / ld, k = idx - m * ld;
  p1[idx] = k < 9 * ch ? conv3x3_patch<BAND, TAP>(z, c, hh, ww, ch, m, k, bd, M)
                       : __float2bfloat16(0.0f);
}

template <bool BAND, int TAP = TAP_MASKED>
cudaError_t stage_patches(int M, int hh, int ww, int c, const float* z, void* p1, const Band& bd,
                          cudaStream_t stream) {
  const int total = M * padded(9 * (c / 2));
  stage_patches_kernel<BAND, TAP><<<ceil_div(total, 256), 256, 0, stream>>>(
      M, hh, ww, c, z, (__nv_bfloat16*)p1, bd);
  return cudaGetLastError();
}

// f() of the coupling from the mixed z (z1 = z1_src[:, :ch], rows c
// apart): conv1's staged patches p1, then h1, h2 (bf16) and the tap-packed
// zero-conv product y (f32), the same launches in both directions and in
// the backward's recompute; with BAND, over staged row bands.  The three
// products run on the wgmma/TMA core, each block summing all of K in
// order (no split-K):
//   h1 = relu((p1 . w1^T + a1b) * e^a1l)   K = 9*ch, N = hidden
//   h2 = relu((h1 . w2^T + a2b) * e^a2l)   K = N = hidden
//   y  = h2 . w3^T                        K = hidden, N = 9*cout
// Anatomy variants: TAP for conv1's patch taps, or with STAGED the given
// (M, padded(9*ch)) bf16 patch tensor `patches` read as it is (p1 is then
// not written).  hidden must be a multiple of 8 (TMA row strides).
template <bool BAND = false, int TAP = TAP_MASKED, bool STAGED = false>
cudaError_t launch_net(int M, int hh, int ww, int c, int hidden, int cout, const float* z1_src,
                       const StepWeights& sw, void* p1, void* h1, void* h2, float* y,
                       cudaStream_t stream, const Band& bd = Band{},
                       const void* patches = nullptr) {
  if (hidden % 8 != 0) return cudaErrorInvalidValue;
  const int p1_ld = padded(9 * (c / 2));
  if constexpr (!STAGED) {
    GLOW_CHECK((stage_patches<BAND, TAP>(M, hh, ww, c, z1_src, p1, bd, stream)));
    patches = p1;
  }
  sm90::Args g = {};
  g.M = M; g.N = hidden; g.K = 9 * (c / 2);
  g.bias = sw.a1b; g.logs = sw.a1l; g.out_bf16 = (__nv_bfloat16*)h1;
  GLOW_CHECK(sm90::gemm_nt<sm90::EPI_ACTNORM_RELU_BF16>(g, patches, p1_ld, sw.w1, p1_ld, stream));
  g.K = hidden;
  g.bias = sw.a2b; g.logs = sw.a2l; g.out_bf16 = (__nv_bfloat16*)h2;
  GLOW_CHECK(sm90::gemm_nt<sm90::EPI_ACTNORM_RELU_BF16>(g, h1, hidden, sw.w2, hidden, stream));
  sm90::Args g3 = {};
  g3.M = M; g3.N = 9 * cout; g3.K = hidden; g3.out_f32 = y;
  return sm90::gemm_nt<sm90::EPI_F32>(g3, h2, hidden, sw.w3, hidden, stream);
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

// Stage `count` bands of the batch into ext (count * (R+4) * ww, c): rows
// outside the image are zero, and with CENTRE_ONLY the halo rows too (a
// cotangent that belongs to the neighbouring bands).  The source is the
// step's input as `bd` lays it out, or with CENTRE_ONLY the centre rows
// alone (T * R rows per image, no lead).  Global offsets in 64 bits.
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
  const int rel = (band % bd.per_image) * bd.rows - 2 + yy;
  const int lead = CENTRE_ONLY ? 0 : bd.lead;
  const int stored = CENTRE_ONLY ? bd.per_image * bd.rows : bd.stored;
  const bool keep =
      row_in_image<true>(bd, j, yy) && (!CENTRE_ONLY || (yy >= 2 && yy < bd.rows + 2));
  ext[idx] = keep ? src[(((size_t)img * stored + lead + rel) * ww + x) * c + ch] : 0.0f;
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
