// The flow step's backward chain, shared by the whole-image backward
// (flowstep_bwd.cu, K3) and the row-band backward (flowstep_band_bwd.cu, K5):
// recompute, then the cotangents of z and of all 12 packed weights.
//
// Chain (`backward_chain`):
//   recompute        v = mix(z), h1, h2, y with the forward's own kernels
//                    (flowstep_common.cuh), so the ReLU masks agree bit for bit
//   coupling_bwd     per (pixel, j): g_raw in the saturation-safe form
//                    go2*(v2+shift)*s(1-s) + g_ld*(1-s), g_v2 = go2*s,
//                    g_acc = g_out*e^{3 l3}, and g_out*out for l3's grad
//   gy_kernel        tap-packed zero-conv cotangent gy (M, 9*cout) in bf16:
//                    the transpose of the forward's 9-tap shift-sum
//   gemm             g_h2 = gy @ w3; epilogue: ReLU mask of h2, * e^{a2l},
//                    g_a2 in bf16, block partials of its bias/logs grads
//   gemm             g_h1 = g_a2 @ w2; the same epilogue with h1
//   gemm             g_p1 = g_a1 @ w1 (f32)
//   gv1_kernel       g_v1 = go1 + col2im(g_p1), the conv1 gather transposed
//   mix_bwd          g_u = W^T g_v, g_z = g_u * e^{anl}, u recomputed
//   wgrad_kernel     gW2 = g_a2^T h1, gW1 = g_a1^T p1 (p1 gathered into
//                    shared memory as conv1 gathers it), gW3 = gy^T h2:
//                    "K = M" products, one partial per chunk of pixels
//   col_partial,     the bias/logs column sums and the C x C mix gradient,
//   outer_partial    one partial per chunk of pixels
//   reduce_partials  each partial set summed in chunk order
//
// With BAND the chain runs over staged row bands (flowstep_common.cuh
// `Band`): every gather and its transpose masks on absolute rows, and g_ld
// applies to the centre rows only (the band's forward logdet sums those).
//
// No float atomics: every sum runs in a fixed order, so two launches on the
// same inputs give the same bits.
//
// The chain's second template parameter (`BwdProd` and the anatomy
// variants in csrc/anatomy.cu) selects what a variant drops or swaps; the
// production chains K3 and K5 take the default.

#pragma once

#include "flowstep_common.cuh"

namespace {

constexpr int WG_LD = BM + 8;    // wgrad shared tile row stride (bf16, multiple of 8)
constexpr int WG_TARGET_BLOCKS = 264;  // about two blocks per SM
constexpr int COL_CHUNK = 256;   // pixels per column-sum partial
constexpr int N_WEIGHTS = 12;

__host__ __device__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Pixels per wgrad partial: enough chunks to give the card about
// WG_TARGET_BLOCKS blocks, each chunk a whole number of BK slices.
int wgrad_chunk(int M, int n1, int n2) {
  const int tiles = ceil_div(n1, BM) * ceil_div(n2, BN);
  int chunks = ceil_div(WG_TARGET_BLOCKS, tiles);
  chunks = chunks < 1 ? 1 : chunks;
  const int rows = ceil_div(ceil_div(M, chunks), BK) * BK;
  return rows;
}

// What a backward-chain variant does; production is every default.
struct BwdProd {
  static constexpr int tap = TAP_MASKED;  // every 3x3 read: conv1, zero-conv, gy, g_v1, gW1
  static constexpr bool staged = false;   // conv1 and gW1 read a dense staged patch tensor
  static constexpr bool accum = true;     // chunk partials summed (else chunk 0's alone)
  static constexpr bool rowsum = true;    // the 8 bias/logs column sums (else 0)
  static constexpr bool wgrad = true;     // any weight gradient (else all 12 are 0)
};

// The 12 packed weights in `pack_weights` order, as the C entries take them.
struct StepWeights {
  const float *wmat, *anb, *anl;
  const void* w1;
  const float *a1b, *a1l;
  const void* w2;
  const float *a2b, *a2l;
  const void* w3;
  const float *b3, *l3;
};

template <bool AFFINE, bool BAND, int TAP = TAP_MASKED>
__global__ void coupling_bwd_kernel(int M, int hh, int ww, int C, const float* v, const float* y,
                                    const float* b3, const float* l3, const float* gzn,
                                    const float* gld, float* gv, float* gacc, float* t3,
                                    Band bd) {
  const int ch = C / 2, cout = AFFINE ? C : ch, hw = hh * ww;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * ch) return;
  const int m = idx / ch, j = idx - m * ch;
  const int img = m / hw, q = m - img * hw;
  const int py = q / ww, px = q - py * ww;
  const float go1 = gzn[m * C + j], go2 = gzn[m * C + ch + j];
  gv[m * C + j] = go1;  // gv1_kernel adds the conv1 cotangent
  const float shift = zero_conv_at<BAND, TAP>(y, img, hh, ww, py, px, cout, j, b3, l3, bd, M);
  float g_v2;
  if (AFFINE) {
    const float raw =
        zero_conv_at<BAND, TAP>(y, img, hh, ww, py, px, cout, ch + j, b3, l3, bd, M);
    const float s = 1.0f / (1.0f + expf(-(raw + 2.0f)));
    const float v2 = v[m * C + ch + j];
    float gl;
    if (BAND)
      gl = (py >= 2 && py < bd.rows + 2) ? gld[(bd.first + img) / bd.per_image] : 0.0f;
    else
      gl = gld[img];
    const float g_raw = go2 * (v2 + shift) * (s * (1.0f - s)) + gl * (1.0f - s);
    g_v2 = go2 * s;
    gacc[m * cout + ch + j] = g_raw * expf(l3[ch + j] * 3.0f);
    t3[m * cout + ch + j] = g_raw * raw;
  } else {
    g_v2 = go2;
  }
  gacc[m * cout + j] = g_v2 * expf(l3[j] * 3.0f);  // d z2 / d shift = s (or 1)
  t3[m * cout + j] = g_v2 * shift;
  gv[m * C + ch + j] = g_v2;
}

// gy[q, k*cout + c] = g_acc[q - off_k, c] where that pixel is in the image
// (and, for a band, where q's absolute row is): the forward summed
// y[p + off_k, k*cout + c] into pixel p.  TAP_WRAP reads pixel
// (q - off_k) mod M, TAP_CENTRE pixel q, neither tested.
template <bool BAND, int TAP = TAP_MASKED>
__global__ void gy_kernel(int M, int hh, int ww, int cout, const float* gacc,
                          __nv_bfloat16* gy, Band bd) {
  static_assert(TAP != TAP_CENTRE_MASKED && (TAP == TAP_MASKED || !BAND), "no such variant");
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * 9 * cout) return;
  const int hw = hh * ww;
  const int m = idx / (9 * cout), r = idx - m * 9 * cout;
  const int k = r / cout, c = r - k * cout;
  if constexpr (TAP != TAP_MASKED) {
    const int src = TAP == TAP_WRAP ? wrap_index(m - (k / 3 - 1) * ww - (k % 3 - 1), M) : m;
    gy[idx] = __float2bfloat16(gacc[src * cout + c]);
    return;
  }
  const int img = m / hw, q = m - img * hw;
  const int py = q / ww - (k / 3 - 1), px = q % ww - (k % 3 - 1);
  float v = 0.0f;
  if (py >= 0 && py < hh && px >= 0 && px < ww && row_in_image<BAND>(bd, img, q / ww))
    v = gacc[(img * hw + py * ww + px) * cout + c];
  gy[idx] = __float2bfloat16(v);
}

// g_v1[p, i] += sum_k g_p1[p - off_k, k*ch + i] over in-image pixels, taps
// in order k = 0..8: the conv1 gather read v1[q + off_k] into patch row q.
// TAP_WRAP reads pixel (p - off_k) mod M, TAP_CENTRE pixel p, neither
// tested.
template <bool BAND, int TAP = TAP_MASKED>
__global__ void gv1_kernel(int M, int hh, int ww, int C, const float* gp1, float* gv, Band bd) {
  static_assert(TAP != TAP_CENTRE_MASKED && (TAP == TAP_MASKED || !BAND), "no such variant");
  const int ch = C / 2, hw = hh * ww;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * ch) return;
  const int m = idx / ch, i = idx - m * ch;
  const int img = m / hw, q = m - img * hw;
  float acc = gv[m * C + i];
  if constexpr (TAP != TAP_MASKED) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int src = TAP == TAP_WRAP ? wrap_index(m - (k / 3 - 1) * ww - (k % 3 - 1), M) : m;
      acc += gp1[src * 9 * ch + k * ch + i];
    }
    gv[m * C + i] = acc;
    return;
  }
  if (row_in_image<BAND>(bd, img, q / ww)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int yy = q / ww - (k / 3 - 1), xx = q % ww - (k % 3 - 1);
      if (yy >= 0 && yy < hh && xx >= 0 && xx < ww)
        acc += gp1[(img * hw + yy * ww + xx) * 9 * ch + k * ch + i];
    }
  }
  gv[m * C + i] = acc;
}

// g_u = W^T g_v, g_z = g_u * e^{anl}; u = (z + anb) * e^{anl} recomputed.
__global__ void mix_bwd_kernel(int M, int C, const float* z, const float* w, const float* anb,
                               const float* anl, const float* gv, float* gz, float* u,
                               float* gu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const int m = idx / C, i = idx - m * C;
  const float* row = gv + m * C;
  float acc = 0.0f;
  for (int o = 0; o < C; ++o) acc = fmaf(w[o * C + i], row[o], acc);
  const float el = expf(anl[i]);
  gz[idx] = acc * el;
  u[idx] = (z[idx] + anb[i]) * el;
  gu[idx] = acc;
}

enum BLoad { B_DENSE = 0, B_CONV3X3 = 1, B_CONV3X3_BAND = 2 };

struct WgradArgs {
  int M, N1, N2, chunk;
  const __nv_bfloat16* a;   // (M, N1) row-major
  const __nv_bfloat16* b;   // B_DENSE: (M, N2) row-major
  const float* z;           // B_CONV3X3: z1 = z[:, :cin] gathered as conv1's patches
  int ldz, hh, ww, cin;
  float* part;              // (chunks, N1, N2)
  Band band;                // B_CONV3X3_BAND
};

// part[chunk, n1, n2] = sum over the chunk's pixels p of A[p, n1] * B[p, n2],
// bf16 operands, f32 accumulation, pixels in order within the chunk.
// B_CONV3X3 reads its taps as TAP says.
template <int BL, int TAP = TAP_MASKED>
__global__ void __launch_bounds__(GEMM_THREADS) wgrad_kernel(WgradArgs g) {
  __shared__ __align__(32) __nv_bfloat16 As[BK * WG_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * WG_LD];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int n10 = blockIdx.x * BM, n20 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * g.chunk;
  const int p_end = min(p_begin + g.chunk, g.M);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
    for (int idx = tid; idx < BK * BM; idx += GEMM_THREADS) {
      const int r = idx / BM, c = idx % BM;
      const int p = p0 + r, n1 = n10 + c;
      As[r * WG_LD + c] =
          (p < p_end && n1 < g.N1) ? g.a[p * g.N1 + n1] : __float2bfloat16(0.0f);
    }
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int p = p0 + r, n2 = n20 + c;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (p < p_end && n2 < g.N2) {
        if (BL == B_DENSE)
          v = g.b[p * g.N2 + n2];
        else
          v = conv3x3_patch<BL == B_CONV3X3_BAND, TAP>(g.z, g.ldz, g.hh, g.ww, g.cin, p, n2,
                                                        g.band, g.M);
      }
      Bs[r * WG_LD + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A^T tile (n1 x p) is the p-major As read column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * WG_LD + wm * 32 + i * 16, WG_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * WG_LD + wn * 32 + j * 16, WG_LD);
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

  float* part = g.part + (size_t)blockIdx.z * g.N1 * g.N2;
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int n1 = n10 + r, n2 = n20 + c;
    if (n1 < g.N1 && n2 < g.N2) part[n1 * g.N2 + n2] = Cs[r * LDC + c];
  }
}

// part[chunk, n] = sum over the chunk's pixels of a[p, n] (* b[p, n]).
template <bool PROD>
__global__ void col_partial_kernel(int M, int N, const float* a, const float* b, float* part) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = ceil_div(M, COL_CHUNK);
  if (idx >= chunks * N) return;
  const int chunk = idx / N, n = idx - chunk * N;
  const int end = min((chunk + 1) * COL_CHUNK, M);
  float s = 0.0f;
  for (int p = chunk * COL_CHUNK; p < end; ++p)
    s += PROD ? a[p * N + n] * b[p * N + n] : a[p * N + n];
  part[idx] = s;
}

// part[chunk, o, i] = sum over the chunk's pixels of gv[p, o] * u[p, i]: the
// mix gradient g_v u^T, in f32.
__global__ void outer_partial_kernel(int M, int C, const float* gv, const float* u,
                                     float* part) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = ceil_div(M, COL_CHUNK);
  if (idx >= chunks * C * C) return;
  const int chunk = idx / (C * C), r = idx - chunk * C * C;
  const int o = r / C, i = r - o * C;
  const int end = min((chunk + 1) * COL_CHUNK, M);
  float s = 0.0f;
  for (int p = chunk * COL_CHUNK; p < end; ++p) s = fmaf(gv[p * C + o], u[p * C + i], s);
  part[idx] = s;
}

// out[n] = scale * sum over parts, in part order.
__global__ void reduce_partials_kernel(int parts, int N, const float* part, float scale,
                                       float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int i = 0; i < parts; ++i) s += part[(size_t)i * N + n];
  out[n] = s * scale;
}

cudaError_t reduce(int parts, int N, const float* part, float scale, float* out,
                   cudaStream_t stream) {
  reduce_partials_kernel<<<ceil_div(N, 256), 256, 0, stream>>>(parts, N, part, scale, out);
  return cudaGetLastError();
}

// Column sum over M pixels by chunk partials; without ACCUM the sum reads
// chunk 0's partial alone (the no_accum variant).
template <bool PROD, bool ACCUM = true>
cudaError_t col_sum(int M, int N, const float* a, const float* b, float scale, float* part,
                    float* out, cudaStream_t stream) {
  const int chunks = ceil_div(M, COL_CHUNK);
  col_partial_kernel<PROD><<<ceil_div(chunks * N, 256), 256, 0, stream>>>(M, N, a, b, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(ACCUM ? chunks : 1, N, part, scale, out, stream);
}

template <int BL, int TAP = TAP_MASKED, bool ACCUM = true>
cudaError_t wgrad(WgradArgs g, float* out, cudaStream_t stream) {
  g.chunk = wgrad_chunk(g.M, g.N1, g.N2);
  const int chunks = ceil_div(g.M, g.chunk);
  dim3 grid(ceil_div(g.N1, BM), ceil_div(g.N2, BN), chunks);
  wgrad_kernel<BL, TAP><<<grid, GEMM_THREADS, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(ACCUM ? chunks : 1, g.N1 * g.N2, g.part, 1.0f, out, stream);
}

// The chain's workspace: every intermediate, each region aligned to 256
// bytes.  With a null base, only counts the bytes.
struct Workspace {
  float *v, *y, *gacc, *t3, *gp1, *gv, *u, *gu;
  __nv_bfloat16 *h1, *h2, *gy, *ga2, *ga1;
  float *part_a2b, *part_a2l, *part_a1b, *part_a1l, *part_w, *part_col;
  size_t bytes;
};

struct Carver {
  char* base;
  size_t off;
  void* take(size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  }
};

Workspace carve(Carver& cv, int M, int c, int hidden, int cout) {
  const int ch = c / 2;
  const size_t gm = (size_t)ceil_div(M, BM);
  const size_t col_chunks = (size_t)ceil_div(M, COL_CHUNK);
  size_t wmax = 0;
  const int dims[3][2] = {{hidden, 9 * ch}, {hidden, hidden}, {9 * cout, hidden}};
  for (const auto& d : dims) {
    const size_t chunks = (size_t)ceil_div(M, wgrad_chunk(M, d[0], d[1]));
    const size_t n = chunks * d[0] * d[1];
    wmax = n > wmax ? n : wmax;
  }
  const size_t col_max = col_chunks * (size_t)(c * c > hidden ? c * c : hidden);
  Workspace w = {};
  const size_t start = cv.off;
  const size_t mm = (size_t)M;
  w.v = (float*)cv.take(mm * c * 4);
  w.h1 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.h2 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.y = (float*)cv.take(mm * 9 * cout * 4);
  w.gacc = (float*)cv.take(mm * cout * 4);
  w.t3 = (float*)cv.take(mm * cout * 4);
  w.gy = (__nv_bfloat16*)cv.take(mm * 9 * cout * 2);
  w.ga2 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.ga1 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.gp1 = (float*)cv.take(mm * 9 * ch * 4);
  w.gv = (float*)cv.take(mm * c * 4);
  w.u = (float*)cv.take(mm * c * 4);
  w.gu = (float*)cv.take(mm * c * 4);
  w.part_a2b = (float*)cv.take(gm * hidden * 4);
  w.part_a2l = (float*)cv.take(gm * hidden * 4);
  w.part_a1b = (float*)cv.take(gm * hidden * 4);
  w.part_a1l = (float*)cv.take(gm * hidden * 4);
  w.part_w = (float*)cv.take(wmax * 4);
  w.part_col = (float*)cv.take(col_max * 4);
  w.bytes = cv.off - start;
  return w;
}

// The backward of one forward step over M staged pixels in images of
// hh x ww (for a band, hh = R + 4 and `bd` places the bands).  z: (M, c)
// step input; gzn: (M, c) output cotangent; gld: per-image logdet
// cotangent.  Writes gz (M, c) and the 12 f32 weight grads g[0..11].
// V: the production chain (BwdProd) or an anatomy variant; `patches`, the
// staged (M, 9*ch) bf16 conv1 patches, is read by V::staged only.
template <bool BAND, class V = BwdProd>
cudaError_t backward_chain(int affine, int M, int hh, int ww, int c, int hidden, const Band& bd,
                           const float* z, const StepWeights& sw, const void* w1t,
                           const void* w2t, const void* w3t, const float* gzn,
                           const float* gld, float* gz, float* const* g, const Workspace& ws,
                           cudaStream_t stream, const void* patches = nullptr) {
  const int ch = c / 2;
  const int cout = affine ? c : ch;
  const int gm = ceil_div(M, BM);

  // -- recompute, with the forward's kernels -----------------------------
  GLOW_CHECK(launch_mix<false>(M, c, z, sw.wmat, sw.anb, sw.anl, ws.v, stream));
  GLOW_CHECK((launch_net<BAND, V::tap, V::staged>(M, hh, ww, c, hidden, cout, ws.v, sw.w1, sw.a1b,
                                                  sw.a1l, sw.w2, sw.a2b, sw.a2l, sw.w3, ws.h1,
                                                  ws.h2, ws.y, stream, bd, patches)));

  // -- coupling and zero-conv ---------------------------------------------
  if (affine)
    coupling_bwd_kernel<true, BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(
        M, hh, ww, c, ws.v, ws.y, sw.b3, sw.l3, gzn, gld, ws.gv, ws.gacc, ws.t3, bd);
  else
    coupling_bwd_kernel<false, BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(
        M, hh, ww, c, ws.v, ws.y, sw.b3, sw.l3, gzn, gld, ws.gv, ws.gacc, ws.t3, bd);
  GLOW_CHECK(cudaGetLastError());
  gy_kernel<BAND, V::tap><<<ceil_div(M * 9 * cout, 256), 256, 0, stream>>>(M, hh, ww, cout,
                                                                           ws.gacc, ws.gy, bd);
  GLOW_CHECK(cudaGetLastError());

  // -- data gradients through the coupling net ----------------------------
  GemmArgs g3 = {};
  g3.M = M; g3.N = hidden; g3.K = 9 * cout;
  g3.a = ws.gy; g3.w = (const __nv_bfloat16*)w3t; g3.logs = sw.a2l; g3.h = ws.h2;
  g3.out_bf16 = ws.ga2; g3.part_b = ws.part_a2b; g3.part_l = ws.part_a2l;
  GLOW_CHECK((launch_gemm<A_DENSE, EPI_RELU_GRAD_BF16, TAP_MASKED, V::rowsum>(g3, stream)));

  GemmArgs g2 = {};
  g2.M = M; g2.N = hidden; g2.K = hidden;
  g2.a = ws.ga2; g2.w = (const __nv_bfloat16*)w2t; g2.logs = sw.a1l; g2.h = ws.h1;
  g2.out_bf16 = ws.ga1; g2.part_b = ws.part_a1b; g2.part_l = ws.part_a1l;
  GLOW_CHECK((launch_gemm<A_DENSE, EPI_RELU_GRAD_BF16, TAP_MASKED, V::rowsum>(g2, stream)));

  GemmArgs g1 = {};
  g1.M = M; g1.N = 9 * ch; g1.K = hidden;
  g1.a = ws.ga1; g1.w = (const __nv_bfloat16*)w1t; g1.out_f32 = ws.gp1;
  GLOW_CHECK((launch_gemm<A_DENSE, EPI_F32>(g1, stream)));

  // -- mix and actnorm ------------------------------------------------------
  gv1_kernel<BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(M, hh, ww, c, ws.gp1,
                                                                      ws.gv, bd);
  GLOW_CHECK(cudaGetLastError());
  mix_bwd_kernel<<<ceil_div(M * c, 256), 256, 0, stream>>>(M, c, z, sw.wmat, sw.anb, sw.anl,
                                                           ws.gv, gz, ws.u, ws.gu);
  GLOW_CHECK(cudaGetLastError());

  // -- weight gradients -------------------------------------------------------
  // The variants that drop a gradient write it as zeros.
  const size_t sizes[N_WEIGHTS] = {
      (size_t)c * c, (size_t)c, (size_t)c, (size_t)hidden * 9 * ch, (size_t)hidden,
      (size_t)hidden, (size_t)hidden * hidden, (size_t)hidden, (size_t)hidden,
      (size_t)9 * cout * hidden, (size_t)cout, (size_t)cout};
  auto zero = [&](int i) { return cudaMemsetAsync(g[i], 0, sizes[i] * sizeof(float), stream); };
  if constexpr (!V::wgrad) {
    for (int i = 0; i < N_WEIGHTS; ++i) GLOW_CHECK(zero(i));
    return cudaSuccess;
  }

  WgradArgs w2g = {};
  w2g.M = M; w2g.N1 = hidden; w2g.N2 = hidden; w2g.a = ws.ga2; w2g.b = ws.h1;
  w2g.part = ws.part_w;
  GLOW_CHECK((wgrad<B_DENSE, TAP_MASKED, V::accum>(w2g, g[6], stream)));

  WgradArgs w1g = {};
  w1g.M = M; w1g.N1 = hidden; w1g.N2 = 9 * ch; w1g.a = ws.ga1;
  w1g.z = ws.v; w1g.ldz = c; w1g.hh = hh; w1g.ww = ww; w1g.cin = ch; w1g.part = ws.part_w;
  w1g.band = bd;
  if constexpr (V::staged) {
    w1g.b = (const __nv_bfloat16*)patches;
    GLOW_CHECK((wgrad<B_DENSE, TAP_MASKED, V::accum>(w1g, g[3], stream)));
  } else {
    GLOW_CHECK((wgrad<BAND ? B_CONV3X3_BAND : B_CONV3X3, V::tap, V::accum>(w1g, g[3], stream)));
  }

  WgradArgs w3g = {};
  w3g.M = M; w3g.N1 = 9 * cout; w3g.N2 = hidden; w3g.a = ws.gy; w3g.b = ws.h2;
  w3g.part = ws.part_w;
  GLOW_CHECK((wgrad<B_DENSE, TAP_MASKED, V::accum>(w3g, g[9], stream)));

  if constexpr (V::rowsum) {
    const int parts = V::accum ? gm : 1;
    GLOW_CHECK(reduce(parts, hidden, ws.part_a2b, 1.0f, g[7], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a2l, 1.0f, g[8], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a1b, 1.0f, g[4], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a1l, 1.0f, g[5], stream));
    GLOW_CHECK((col_sum<false, V::accum>(M, cout, ws.gacc, nullptr, 1.0f, ws.part_col, g[10],
                                         stream)));
    GLOW_CHECK((col_sum<false, V::accum>(M, cout, ws.t3, nullptr, 3.0f, ws.part_col, g[11],
                                         stream)));
    GLOW_CHECK((col_sum<false, V::accum>(M, c, gz, nullptr, 1.0f, ws.part_col, g[1], stream)));
    GLOW_CHECK((col_sum<true, V::accum>(M, c, ws.gu, ws.u, 1.0f, ws.part_col, g[2], stream)));
  } else {
    const int rowsums[] = {1, 2, 4, 5, 7, 8, 10, 11};
    for (int i : rowsums) GLOW_CHECK(zero(i));
  }

  const int chunks = ceil_div(M, COL_CHUNK);
  outer_partial_kernel<<<ceil_div(chunks * c * c, 256), 256, 0, stream>>>(M, c, ws.gv, ws.u,
                                                                          ws.part_col);
  GLOW_CHECK(cudaGetLastError());
  GLOW_CHECK(reduce(V::accum ? chunks : 1, c * c, ws.part_col, 1.0f, g[0], stream));
  return cudaSuccess;
}

}  // namespace
