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

// -- the 1x1 channel mix in f32 -------------------------------------------------
//
//   forward: out = W @ ((z + b) * e^l)      reverse: out = (W @ t) * e^-l - b
//
// (W the (C, C) mix, its inverse in reverse), and in the backward chain
// g_u = W^T g_v with its actnorm epilogue and the mix gradient's chunk
// partials g_v u^T (`MixForm`).  A tiled f32 product on the CUDA cores,
// `mix_tile_kernel<BN, FORM>`: a block owns BM = 4096 / BN rows (pixels)
// by BN output channels, each of its 256 threads a 4 x 4 register tile.
// The block stages MIX_BK summed indices at a time of both operands,
// k-major (transposed as they are copied where k is contiguous in the
// source), by 4-byte cp.async into a ring of 2-4 stages, so the next
// chunks' copies fly while a chunk's products run; each thread's 4 x 4
// operands are then two float4 reads, free of bank conflicts.  The
// forward's actnorm is applied once to each staged input, in place, by
// the thread that copied it, from b and e^l staged once per block; the
// reverse's actnorm inverse and the backward's e^l once per output column
// in the epilogue.  BN is 16, 32 or 64, by C (`launch_mix_form`), so a
// narrow C wastes at most a quarter of a tile; the ragged edges are
// masked (no padded index is ever summed).
//
// Precision and bits: true f32, no TF32 (the TPU kernel multiplies at
// HIGHEST).  Every output starts at 0 and adds fmaf(W[o, i], v[m, i]) for
// i = 0..C-1 in order (the mix gradient: over its chunk's pixels in
// order), with no split of the sum: the order of a one-thread-per-output
// loop, so K1, K3's recompute and the band chain's centre rows agree bit
// for bit, and encode/decode stay exact.
//
// What bounds it: at C >= 96 the f32 FMAs (M C^2 of them, 67 TFLOP/s);
// at C <= 48 the bytes (z in, the mixed z out).  At the 4x4 levels few
// blocks run (96 at 4x4x384, b=64), each C / 16 chunks deep, so the ring
// is 4 deep there and a whole chunk's products run unrolled and untested.

constexpr int MIX_THREADS = 256;
constexpr int MIX_BK = 16;  // input channels a staged chunk
constexpr int MIX_T = 4;    // a thread's register tile is MIX_T x MIX_T

template <int BN>
struct MixTile {
  static constexpr int BM = MIX_THREADS * MIX_T * MIX_T / BN;  // pixels a block
  static constexpr int TX = BN / MIX_T;                        // threads along the outputs
  static constexpr int ROWS = MIX_THREADS / MIX_BK;            // rows a copy pass covers
  static constexpr int A_PER = BM / ROWS, B_PER = BN / ROWS;   // copies a thread per chunk
  // k-major rows, padded so that the transposing copies spread over the
  // banks and each row stays 16-byte aligned.
  static constexpr int SA = BM + 4, SB = BN + 4;
  // Chunks in flight: C <= 16 is one chunk; the wide tiles hide the L2
  // round trip of a chunk's copies behind three chunks' products.
  static constexpr int STAGES = BN == 16 ? 2 : BN == 32 ? 3 : 4;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>  // all but the newest PENDING groups landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// What a mix_tile_kernel launch computes.  The tile's rows are pixels
// (the forms' M) but for MIX_OUTER, whose rows are output channels o.
enum MixForm {
  MIX_FWD = 0,        // out = W (z + b) e^l
  MIX_REV = 1,        // out = (W t) e^-l - b
  MIX_REV_SPLIT = 2,  // MIX_REV with inputs C/2.. from a2 (M, C/2)
  MIX_BWD = 3,        // g_u = W^T g_v; out = g_z = g_u e^l, u = (z + b) e^l, gu = g_u
  MIX_OUTER = 4,      // out[chunk, o, i] = sum over the chunk's pixels p of a[p, o] a2[p, i]
};

struct MixArgs {
  int M, C;
  const float* a;    // the rows' inputs, (M, C): z, t, g_v; MIX_OUTER: g_v
  const float* a2;   // MIX_REV_SPLIT: z2' (M, C/2); MIX_OUTER: u (M, C)
  const float* w;    // the (C, C) mix, its inverse for the reverse
  const float *anb, *anl;
  const float* z;    // MIX_BWD: the step input
  float* out;        // the result (MIX_BWD: g_z; MIX_OUTER: the (chunks, C, C) partials)
  float *u, *gu;     // MIX_BWD
  int chunk, split;  // MIX_OUTER: pixel chunks as sm90::chunk_range cuts them
  int vec;           // out, and for MIX_BWD z, u and gu, take float4 stores / loads
};

template <int BN, int FORM>
__global__ void __launch_bounds__(MIX_THREADS) mix_tile_kernel(const MixArgs g) {
  using T = MixTile<BN>;
  constexpr bool ROWS_ARE_PIXELS = FORM != MIX_OUTER;
  // Whether a staged operand is copied as it lies (k its row, the tile's
  // row or column contiguous) or transposed (k contiguous in the source).
  constexpr bool A_DIRECT = FORM == MIX_OUTER, B_DIRECT = FORM == MIX_BWD || FORM == MIX_OUTER;
  constexpr bool ACTNORM = FORM == MIX_FWD || FORM == MIX_BWD;  // `an` staged
  __shared__ __align__(16) float as[T::STAGES][MIX_BK][T::SA];  // as[k][row]
  __shared__ __align__(16) float bs[T::STAGES][MIX_BK][T::SB];  // bs[k][column]
  extern __shared__ float an[];  // an[k] = b[k], an[C + k] = e^l[k]
  const int C = g.C;
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int rows = ROWS_ARE_PIXELS ? g.M : C;
  int k_begin = 0, k_end = C;  // the summed index: input channels, or pixels
  if (FORM == MIX_OUTER) sm90::chunk_range(blockIdx.z, g.M, g.chunk, g.split, &k_begin, &k_end);
  const int chunks = ceil_div(k_end - k_begin, MIX_BK);
  // Transposing copies: thread tid takes k = lk of rows lr + ROWS * p, so
  // 16 neighbouring threads read 16 neighbouring floats of a source row.
  const int lk = tid % MIX_BK, lr = tid / MIX_BK;

  auto stage = [&](int kc, int buf) {
    const int kb = k_begin + kc * MIX_BK;
#pragma unroll
    for (int p = 0; p < T::A_PER; ++p) {
      const int e = tid + p * MIX_THREADS;
      const int kk = A_DIRECT ? e / T::BM : lk, r = A_DIRECT ? e % T::BM : lr + p * T::ROWS;
      const int k = kb + kk, m = m0 + r;
      const bool ok = k < k_end && m < rows;
      const float* src = g.a;
      if (ok) {
        if (A_DIRECT)
          src = g.a + (size_t)k * C + m;
        else if (FORM == MIX_REV_SPLIT && k >= C / 2)
          src = g.a2 + (size_t)m * (C / 2) + (k - C / 2);
        else
          src = g.a + (size_t)m * C + k;
      }
      cp_async4(&as[buf][kk][r], src, ok);
    }
#pragma unroll
    for (int p = 0; p < T::B_PER; ++p) {
      const int e = tid + p * MIX_THREADS;
      const int kk = B_DIRECT ? e / BN : lk, n = B_DIRECT ? e % BN : lr + p * T::ROWS;
      const int k = kb + kk, col = n0 + n;
      const bool ok = k < k_end && col < C;
      const float* src = FORM == MIX_OUTER ? g.a2 : g.w;
      if (ok)
        src = FORM == MIX_OUTER ? g.a2 + (size_t)k * C + col
              : B_DIRECT        ? g.w + (size_t)k * C + col
                                : g.w + (size_t)col * C + k;
      cp_async4(&bs[buf][kk][n], src, ok);
    }
  };

  float acc[MIX_T][MIX_T];
#pragma unroll
  for (int i = 0; i < MIX_T; ++i)
#pragma unroll
    for (int j = 0; j < MIX_T; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < chunks) stage(s, s);
    cp_async_commit();
  }
  if (ACTNORM)  // while the first chunks' copies fly
    for (int k = tid; k < C; k += MIX_THREADS) {
      an[k] = g.anb[k];
      an[C + k] = expf(g.anl[k]);
    }
  __syncthreads();  // `an` in place
  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc % T::STAGES;
    if (kc + T::STAGES - 1 < chunks) stage(kc + T::STAGES - 1, (kc + T::STAGES - 1) % T::STAGES);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();  // this thread's copies of chunk kc
    if (FORM == MIX_FWD && kc * MIX_BK + lk < C) {  // the actnorm, on the copies this thread made
      const float b = an[kc * MIX_BK + lk], el = an[C + kc * MIX_BK + lk];
#pragma unroll
      for (int p = 0; p < T::A_PER; ++p) {
        float& v = as[buf][lk][lr + p * T::ROWS];
        v = (v + b) * el;
      }
    }
    __syncthreads();
    auto product = [&](int kk) {  // k = chunk start + kk, added to every output
      const float4 a = *reinterpret_cast<const float4*>(&as[buf][kk][ty * MIX_T]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * MIX_T]);
      const float av[MIX_T] = {a.x, a.y, a.z, a.w}, bv[MIX_T] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MIX_T; ++i)
#pragma unroll
        for (int j = 0; j < MIX_T; ++j) acc[i][j] = fmaf(bv[j], av[i], acc[i][j]);
    };
    const int kmax = k_end - k_begin - kc * MIX_BK;
    if (kmax >= MIX_BK) {  // a whole chunk: unrolled with no test, its loads run ahead
#pragma unroll
      for (int kk = 0; kk < MIX_BK; ++kk) product(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < MIX_BK; ++kk)
        if (kk < kmax) product(kk);
    }
    __syncthreads();  // every thread is done with buf before it is refilled
  }

  // The epilogue: this thread's 4 x 4 outputs, rows m, columns o0 + j.
  const int o0 = n0 + tx * MIX_T;
  const bool full = g.vec && o0 + MIX_T <= C;
  float ea[MIX_T] = {}, eb[MIX_T] = {};  // the reverse's e^-l and b, the backward's e^l and b
  if (FORM == MIX_REV || FORM == MIX_REV_SPLIT || FORM == MIX_BWD) {
#pragma unroll
    for (int j = 0; j < MIX_T; ++j) {
      if (o0 + j < C) {
        ea[j] = FORM == MIX_BWD ? an[C + o0 + j] : expf(-g.anl[o0 + j]);
        eb[j] = FORM == MIX_BWD ? an[o0 + j] : g.anb[o0 + j];
      }
    }
  }
  auto put = [&](float* base, size_t at, const float (&r)[MIX_T]) {
    if (full) {
      *reinterpret_cast<float4*>(base + at) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < MIX_T; ++j)
        if (o0 + j < C) base[at + j] = r[j];
    }
  };
#pragma unroll
  for (int i = 0; i < MIX_T; ++i) {
    const int m = m0 + ty * MIX_T + i;
    if (m >= rows) break;
    const size_t at = FORM == MIX_OUTER ? ((size_t)blockIdx.z * C + m) * C + o0
                                        : (size_t)m * C + o0;
    float r[MIX_T];
    if constexpr (FORM == MIX_BWD) {
      float zv[MIX_T] = {}, uv[MIX_T];
      if (full) {
        const float4 z4 = *reinterpret_cast<const float4*>(g.z + at);
        zv[0] = z4.x, zv[1] = z4.y, zv[2] = z4.z, zv[3] = z4.w;
      } else {
#pragma unroll
        for (int j = 0; j < MIX_T; ++j)
          if (o0 + j < C) zv[j] = g.z[at + j];
      }
#pragma unroll
      for (int j = 0; j < MIX_T; ++j) {
        r[j] = acc[i][j] * ea[j];
        uv[j] = (zv[j] + eb[j]) * ea[j];
      }
      put(g.out, at, r);
      put(g.u, at, uv);
      put(g.gu, at, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < MIX_T; ++j)
        r[j] = FORM == MIX_REV || FORM == MIX_REV_SPLIT ? acc[i][j] * ea[j] - eb[j] : acc[i][j];
      put(g.out, at, r);
    }
  }
}

template <int BN, int FORM>
cudaError_t launch_mix_tile(MixArgs g, int chunks, cudaStream_t stream) {
  using T = MixTile<BN>;
  constexpr int static_bytes = T::STAGES * MIX_BK * (T::SA + T::SB) * (int)sizeof(float);
  const int dynamic_bytes = FORM == MIX_FWD || FORM == MIX_BWD ? 2 * g.C * (int)sizeof(float) : 0;
  auto kernel = mix_tile_kernel<BN, FORM>;
  if (static_bytes + dynamic_bytes > 48 * 1024)
    GLOW_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dynamic_bytes));
  const int rows = FORM == MIX_OUTER ? g.C : g.M;
  const dim3 grid(ceil_div(rows, T::BM), ceil_div(g.C, BN), chunks);
  bool vec = g.C % 4 == 0 && reinterpret_cast<uintptr_t>(g.out) % 16 == 0;
  if (FORM == MIX_BWD)
    vec = vec && (reinterpret_cast<uintptr_t>(g.z) | reinterpret_cast<uintptr_t>(g.u) |
                  reinterpret_cast<uintptr_t>(g.gu)) % 16 == 0;
  g.vec = vec;
  kernel<<<grid, MIX_THREADS, dynamic_bytes, stream>>>(g);
  return cudaGetLastError();
}

// The tile width by C: 16 up to C = 16, 32 up to 32, else 64 where it
// divides C or C <= 64 (one output tile), else 32 (C = 96: three tiles).
template <int FORM>
cudaError_t launch_mix_form(const MixArgs& g, cudaStream_t stream, int chunks = 1) {
  if (g.C <= 16) return launch_mix_tile<16, FORM>(g, chunks, stream);
  if (g.C <= 32 || (g.C > 64 && g.C % 64 != 0)) return launch_mix_tile<32, FORM>(g, chunks, stream);
  return launch_mix_tile<64, FORM>(g, chunks, stream);
}

// The mix over M pixels (the forward's, or the reverse's; with SPLIT the
// reverse reading inputs C/2.. from z2 (M, C/2)).
template <bool REVERSE, bool SPLIT = false>
cudaError_t launch_mix(int M, int C, const float* zin, const float* w, const float* anb,
                       const float* anl, float* out, cudaStream_t stream,
                       const float* z2 = nullptr) {
  MixArgs g = {};
  g.M = M; g.C = C; g.a = zin; g.a2 = z2; g.w = w; g.anb = anb; g.anl = anl; g.out = out;
  constexpr int form = !REVERSE ? MIX_FWD : SPLIT ? MIX_REV_SPLIT : MIX_REV;
  return launch_mix_form<form>(g, stream);
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

// -- the coupling update and the logdet ---------------------------------------
//
// One thread per (pixel, channel) pair j < ch: consecutive threads take
// consecutive channels of a pixel, so the nine tap rows of y and the z
// rows are read coalesced.  A block covers `coupling_pixels(ch)` pixels of
// one unit (an image, or a band's centre rows), 512-1024 pairs, so a 4x4
// image at C = 384 spreads over 4 blocks and the batch over b * 4.  The
// forward's logdet is a fixed-order two-stage sum: each block's threads
// add their pairs' log_sigmoid in pair order, the block sums its 256 in a
// fixed tree into one partial of its pixel range, and `ld_sum_kernel`
// adds each image's partials in order (no atomics: bitwise repeatable).
// What bounds it: the bytes, y's tap rows (9 or 18 floats a pair) read
// once with the z rows.

constexpr int COUPLING_PAIRS = 1024;

// Pixels a coupling block covers: the largest power of two whose pairs
// over ch channels stay within COUPLING_PAIRS (1 at ch >= 1024).
__host__ __device__ inline int coupling_pixels(int ch) {
  int p = 1;
  while (2 * p * ch <= COUPLING_PAIRS) p *= 2;
  return p;
}

// The update over the centre pixels of unit u = blockIdx.y: an image of
// hh x ww (whole), or band u of the launch (BAND: `bd.rows` centre rows
// of an (R+4)-row staged image, read from its row 2).  zsrc and zdst may
// alias (the forward updates the mixed z in place): each element is read
// and written by one thread.  The forward writes the block's logdet
// partial to ld_part[unit * gridDim.x + blockIdx.x] (AFFINE, unit = the
// image, or bd.first + u for a band).  A band's forward writes the global
// output (rows of bd.first + u), its reverse a (count * R * ww, C)
// scratch.  Anatomy variants (whole images only): TAP for the zero-conv's
// taps, FORM for the update (FORM_SPLIT writes z2' alone into zdst, an
// (M, C/2) buffer; FORM_NO_LOGDET writes no partial).
template <bool BAND, bool REVERSE, bool AFFINE, int TAP = TAP_MASKED, int FORM = FORM_PROD>
__global__ void __launch_bounds__(ROW_THREADS)
    coupling_update_kernel(int hh, int ww, int C, Band bd, const float* zsrc, const float* y,
                           const float* b3, const float* l3, float* zdst, float* ld_part) {
  static_assert(!BAND || (TAP == TAP_MASKED && FORM == FORM_PROD), "no band variants");
  __shared__ float red[ROW_THREADS];
  const int u = blockIdx.y, ch = C / 2, cout = AFFINE ? C : ch;
  const int rows = BAND ? bd.rows : hh, lead = BAND ? 2 : 0;
  const int pix = coupling_pixels(ch), p0 = blockIdx.x * pix;
  const int npix = min(pix, rows * ww - p0);
  const int total = TAP == TAP_WRAP ? (int)gridDim.y * hh * ww : 0;
  const int dst_unit = BAND && !REVERSE ? bd.first + u : u;
  float part = 0.0f;
  for (int e = threadIdx.x; e < npix * ch; e += ROW_THREADS) {
    const int q = p0 + e / ch, j = e % ch;
    const int py = lead + q / ww, px = q % ww;
    const float* src = zsrc + ((size_t)(u * hh + py) * ww + px) * C;
    const size_t at = (size_t)dst_unit * rows * ww + q;
    const float z1 = src[j];
    float z2 = src[ch + j];
    const float h = zero_conv_at<BAND, TAP>(y, u, hh, ww, py, px, cout, j, b3, l3, bd, total);
    if (AFFINE) {
      const float raw =
          zero_conv_at<BAND, TAP>(y, u, hh, ww, py, px, cout, ch + j, b3, l3, bd, total) + 2.0f;
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
      zdst[at * ch + j] = z2;
    } else {
      zdst[at * C + j] = z1;
      zdst[at * C + ch + j] = z2;
    }
  }
  if (REVERSE || !AFFINE || FORM == FORM_NO_LOGDET) return;
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = ROW_THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld_part[(size_t)(BAND ? bd.first + u : u) * gridDim.x + blockIdx.x] = red[0];
}

// ld[img] = the sum of the image's `parts` logdet partials, in order; 0
// where there are none (additive, or the no_logdet variant).
__global__ void ld_sum_kernel(int b, int parts, const float* part, float* ld) {
  const int img = blockIdx.x * blockDim.x + threadIdx.x;
  if (img >= b) return;
  float s = 0.0f;
  for (int t = 0; t < parts; ++t) s += part[(size_t)img * parts + t];
  ld[img] = s;
}

cudaError_t ld_sum(int b, int parts, const float* part, float* ld, cudaStream_t stream) {
  ld_sum_kernel<<<ceil_div(b, 256), 256, 0, stream>>>(b, parts, part, ld);
  return cudaGetLastError();
}

// Blocks of the update per unit of `pixels` centre pixels.
inline int coupling_parts(int pixels, int c) { return ceil_div(pixels, coupling_pixels(c / 2)); }

// The update over `units` images of hh x ww, or with BAND over the
// launch's `units` bands (`bd`, hh = R + 4), then for the whole-image
// forward the logdet: the partials go to ld_part (b * coupling_parts(hh *
// ww, C) floats) and ld[img] is their sum (0 unless affine).  A band
// forward leaves its partials, coupling_parts(R * ww, C) a band, for the
// caller's one ld_sum over all groups.
template <bool BAND, bool REVERSE, int TAP = TAP_MASKED, int FORM = FORM_PROD>
cudaError_t launch_coupling(int affine, int units, int hh, int ww, int C, const Band& bd,
                            const float* zsrc, const float* y, const float* b3, const float* l3,
                            float* zdst, float* ld, float* ld_part, cudaStream_t stream) {
  const int parts = coupling_parts((BAND ? bd.rows : hh) * ww, C);
  const dim3 grid(parts, units);
  if (affine)
    coupling_update_kernel<BAND, REVERSE, true, TAP, FORM><<<grid, ROW_THREADS, 0, stream>>>(
        hh, ww, C, bd, zsrc, y, b3, l3, zdst, ld_part);
  else
    coupling_update_kernel<BAND, REVERSE, false, TAP, FORM><<<grid, ROW_THREADS, 0, stream>>>(
        hh, ww, C, bd, zsrc, y, b3, l3, zdst, ld_part);
  GLOW_CHECK(cudaGetLastError());
  if (BAND || REVERSE) return cudaSuccess;
  return ld_sum(units, affine && FORM != FORM_NO_LOGDET ? parts : 0, ld_part, ld, stream);
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
