// The flow step's backward chain, shared by the whole-image backward
// (flowstep_bwd.cu, K3) and the row-band backward (flowstep_band_bwd.cu, K5):
// recompute, then the cotangents of z and of all 12 packed weights.
//
// Chain (`backward_chain`):
//   recompute        v = mix(z), conv1's patches p1, h1, h2, y with the
//                    forward's own `launch_net` (flowstep_common.cuh), so the
//                    ReLU masks agree bit for bit
//   coupling_bwd     per (pixel, j): g_raw in the saturation-safe form
//                    go2*(v2+shift)*s(1-s) + g_ld*(1-s), g_v2 = go2*s,
//                    g_acc = g_out*e^{3 l3}, and g_out*out for l3's grad
//   gy_kernel        tap-packed zero-conv cotangent gy (M, 9*cout) in bf16:
//                    the transpose of the forward's 9-tap shift-sum
//   gemm_nt          g_h2 = gy @ w3 on the wgmma/TMA core (gemm_sm90.cuh);
//                    epilogue: ReLU mask of h2, * e^{a2l}, g_a2 in bf16,
//                    block partials of its bias/logs grads
//   gemm_nt          g_h1 = g_a2 @ w2; the same epilogue with h1
//   gemm_nt          g_p1 = g_a1 @ w1 (f32)
//   gv1_kernel       g_v1 = go1 + col2im(g_p1), the conv1 gather transposed
//   mix_tile_kernel  g_u = W^T g_v, g_z = g_u * e^{anl}, u recomputed: the
//                    forward's tiled f32 mix (flowstep_common.cuh), MIX_BWD
//   weight_grad      gW2 = g_a2^T h1, gW1 = g_a1^T p1 (the recompute's
//                    patches), gW3 = gy^T h2 on the core: "K = M" products
//                    read pixel-major, one partial per chunk of pixels
//   col_partial,     the bias/logs column sums and the C x C mix gradient,
//   outer_partials   one partial per chunk of pixels (the mix gradient's
//                    on the tiled mix, MIX_OUTER, at C >= 32)
//   reduce_partials  each partial set summed in chunk order
//
// The bf16 operands the core reads through TMA need row strides of a
// multiple of 16 bytes: gy and p1 rows are padded to a multiple of 8
// columns (`padded`), the pad zero, and so are the wrapper's copies of w1
// and its transposed w3.
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

constexpr int COL_CHUNK = 256;   // pixels per column-sum partial
constexpr int N_WEIGHTS = 12;

// What a backward-chain variant does; production is every default.
struct BwdProd {
  static constexpr int tap = TAP_MASKED;  // every 3x3 read: conv1, zero-conv, gy, g_v1, p1
  static constexpr bool staged = false;   // the recompute's conv1 reads the given staged patches
  static constexpr bool accum = true;     // every chunk partial summed (else the last tile's)
  static constexpr bool rowsum = true;    // the 8 bias/logs column sums (else 0)
  static constexpr bool wgrad = true;     // any weight gradient (else all 12 are 0)
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
// y[p + off_k, k*cout + c] into pixel p.  Rows are padded(9*cout) long,
// the pad zero.  TAP_WRAP reads pixel (q - off_k) mod M, TAP_CENTRE pixel
// q, neither tested.
template <bool BAND, int TAP = TAP_MASKED>
__global__ void gy_kernel(int M, int hh, int ww, int cout, const float* gacc,
                          __nv_bfloat16* gy, Band bd) {
  static_assert(TAP != TAP_CENTRE_MASKED && (TAP == TAP_MASKED || !BAND), "no such variant");
  const int ld = padded(9 * cout);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * ld) return;
  const int hw = hh * ww;
  const int m = idx / ld, r = idx - m * ld;
  const int k = r / cout, c = r - k * cout;
  if (k >= 9) {
    gy[idx] = __float2bfloat16(0.0f);
    return;
  }
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

// Partial sums over pixel chunks of `chunk` pixels, cut at `split` as
// gemm_sm90.cuh `chunk_range` cuts them (split = 0: plain chunks).

// part[chunk, n] = sum over the chunk's pixels of a[p, n] (* b[p, n]).
template <bool PROD>
__global__ void col_partial_kernel(int M, int N, int chunk, int split, const float* a,
                                   const float* b, float* part) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sm90::chunk_count(M, chunk, split) * N) return;
  const int z = idx / N, n = idx - z * N;
  int begin, end;
  sm90::chunk_range(z, M, chunk, split, &begin, &end);
  float s = 0.0f;
  for (int p = begin; p < end; ++p) s += PROD ? a[p * N + n] * b[p * N + n] : a[p * N + n];
  part[idx] = s;
}

// part[chunk, o, i] = sum over the chunk's pixels of gv[p, o] * u[p, i]: the
// mix gradient g_v u^T, in f32, one thread per output, pixels in order.
// At C >= OUTER_TILED_C the tiled mix kernel's MIX_OUTER form computes the
// same sums (`outer_partials`).
__global__ void outer_partial_kernel(int M, int C, int chunk, int split, const float* gv,
                                     const float* u, float* part) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sm90::chunk_count(M, chunk, split) * C * C) return;
  const int z = idx / (C * C), r = idx - z * C * C;
  const int o = r / C, i = r - o * C;
  int begin, end;
  sm90::chunk_range(z, M, chunk, split, &begin, &end);
  float s = 0.0f;
  for (int p = begin; p < end; ++p) s = fmaf(gv[p * C + o], u[p * C + i], s);
  part[idx] = s;
}

// out[n] = scale * sum over parts, in a fixed order: strand s of the
// block's blockDim.y strands sums parts s, s + blockDim.y, ... in order,
// then the strand sums are added in strand order.
constexpr int RED_STRANDS = 16;

__global__ void reduce_partials_kernel(int parts, int N, const float* part, float scale,
                                       float* out) {
  __shared__ float red[RED_STRANDS][33];
  const int n = blockIdx.x * 32 + threadIdx.x, strand = threadIdx.y, strands = blockDim.y;
  float s = 0.0f;
  if (n < N)
    for (int i = strand; i < parts; i += strands) s += part[(size_t)i * N + n];
  red[strand][threadIdx.x] = s;
  __syncthreads();
  if (strand == 0 && n < N) {
    float t = 0.0f;
    for (int k = 0; k < strands; ++k) t += red[k][threadIdx.x];
    out[n] = t * scale;
  }
}

// The mix gradient's chunk partials: below OUTER_TILED_C a chunk's C x C
// outputs are too few for the tiles, so one thread per output (at C = 12
// the tiles measured 3.4x slower, at 24 even, from 48 2.4x faster).
constexpr int OUTER_TILED_C = 32;

cudaError_t outer_partials(int M, int C, int split, const float* gv, const float* u, float* part,
                           cudaStream_t stream) {
  const int chunks = sm90::chunk_count(M, COL_CHUNK, split);
  if (C >= OUTER_TILED_C) {
    MixArgs g = {};
    g.M = M; g.C = C; g.a = gv; g.a2 = u; g.out = part; g.chunk = COL_CHUNK; g.split = split;
    return launch_mix_form<MIX_OUTER>(g, stream, chunks);
  }
  outer_partial_kernel<<<ceil_div(chunks * C * C, 256), 256, 0, stream>>>(M, C, COL_CHUNK, split,
                                                                          gv, u, part);
  return cudaGetLastError();
}

cudaError_t reduce(int parts, int N, const float* part, float scale, float* out,
                   cudaStream_t stream) {
  const int strands = parts < 1 ? 1 : parts < RED_STRANDS ? parts : RED_STRANDS;
  reduce_partials_kernel<<<ceil_div(N, 32), dim3(32, strands), 0, stream>>>(parts, N, part,
                                                                           scale, out);
  return cudaGetLastError();
}

// The partials of chunk_count(M, chunk, split) that a reduction sums, from
// `first` on: every one, or with ACCUM false (the no_accum variant) those
// of the last batch tile, which starts at pixel `split`.
template <bool ACCUM>
cudaError_t reduce_from(int M, int chunk, int split, int N, const float* part, float scale,
                        float* out, cudaStream_t stream) {
  const int first = ACCUM ? 0 : ceil_div(split, chunk);
  return reduce(sm90::chunk_count(M, chunk, split) - first, N, part + (size_t)first * N, scale,
                out, stream);
}

// Column sum over M pixels by chunk partials.
template <bool PROD, bool ACCUM = true>
cudaError_t col_sum(int M, int N, int split, const float* a, const float* b, float scale,
                    float* part, float* out, cudaStream_t stream) {
  const int chunks = sm90::chunk_count(M, COL_CHUNK, split);
  col_partial_kernel<PROD><<<ceil_div(chunks * N, 256), 256, 0, stream>>>(M, N, COL_CHUNK, split,
                                                                         a, b, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_from<ACCUM>(M, COL_CHUNK, split, N, part, scale, out, stream);
}

// A weight gradient A^T B over M pixels (gemm_sm90.cuh `weight_grad_partials`:
// one partial per chunk, cut at `split`), then its partials summed in order.
template <bool ACCUM>
cudaError_t weight_grad(int M, int n1, int n2, const void* a, int lda, const void* b, int ldb,
                        int split, float* part, float* out, cudaStream_t stream) {
  const int chunk = sm90::wgrad_chunk(M, n1, n2);
  GLOW_CHECK(sm90::weight_grad_partials(M, n1, n2, a, lda, b, ldb, chunk, split, part, stream));
  return reduce_from<ACCUM>(M, chunk, split, n1 * n2, part, 1.0f, out, stream);
}

// The chain's workspace: every intermediate, each region aligned to 256
// bytes.  With a null base, only counts the bytes.  `split` (the no_accum
// variant's last-tile start, else 0) may add one chunk to each partial set.
struct Workspace {
  float *v, *y, *gacc, *t3, *gp1, *gv, *u, *gu;
  __nv_bfloat16 *h1, *h2, *gy, *ga2, *ga1, *p1;
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

Workspace carve(Carver& cv, int M, int c, int hidden, int cout, int split = 0) {
  const int ch = c / 2;
  const size_t gm = (size_t)ceil_div(M, sm90::TM);
  const size_t col_chunks = (size_t)sm90::chunk_count(M, COL_CHUNK, split);
  size_t wmax = 0;
  const int dims[3][2] = {{hidden, 9 * ch}, {hidden, hidden}, {9 * cout, hidden}};
  for (const auto& d : dims) {
    const int chunk = sm90::wgrad_chunk(M, d[0], d[1]);
    const size_t n = (size_t)sm90::chunk_count(M, chunk, split) * d[0] * d[1];
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
  w.gy = (__nv_bfloat16*)cv.take(mm * padded(9 * cout) * 2);
  w.ga2 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.ga1 = (__nv_bfloat16*)cv.take(mm * hidden * 2);
  w.gp1 = (float*)cv.take(mm * 9 * ch * 4);
  w.gv = (float*)cv.take(mm * c * 4);
  w.u = (float*)cv.take(mm * c * 4);
  w.gu = (float*)cv.take(mm * c * 4);
  w.p1 = (__nv_bfloat16*)cv.take(mm * padded(9 * ch) * 2);
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
// cotangent; w1t (9*ch, hidden), w2t (hidden, hidden) and w3t
// (hidden, padded(9*cout)), the pad zero: the bf16 transposes of w1, w2,
// w3.  Writes gz (M, c) and the 12 f32 weight grads g[0..11].
// V: the production chain (BwdProd) or an anatomy variant; `patches`, the
// staged (M, padded(9*ch)) bf16 conv1 patches, is read by V::staged only;
// `split`, the pixel where the last batch tile starts, by !V::accum only
// (a multiple of sm90::TM, so that every chunking has a boundary there).
// The core needs hidden to be a multiple of 8 (its TMA row strides).
template <bool BAND, class V = BwdProd>
cudaError_t backward_chain(int affine, int M, int hh, int ww, int c, int hidden, const Band& bd,
                           const float* z, const StepWeights& sw, const void* w1t,
                           const void* w2t, const void* w3t, const float* gzn,
                           const float* gld, float* gz, float* const* g, const Workspace& ws,
                           cudaStream_t stream, const void* patches = nullptr, int split = 0) {
  const int ch = c / 2;
  const int cout = affine ? c : ch;
  const int gy_ld = padded(9 * cout), p1_ld = padded(9 * ch);
  if (V::accum) split = 0;
  if (split % sm90::TM != 0) return cudaErrorInvalidValue;

  // -- recompute, with the forward's kernels; p1 stays for gW1 -------------
  GLOW_CHECK(launch_mix<false>(M, c, z, sw.wmat, sw.anb, sw.anl, ws.v, stream));
  GLOW_CHECK((launch_net<BAND, V::tap, V::staged>(M, hh, ww, c, hidden, cout, ws.v, sw, ws.p1,
                                                  ws.h1, ws.h2, ws.y, stream, bd, patches)));

  // -- coupling and zero-conv ---------------------------------------------
  if (affine)
    coupling_bwd_kernel<true, BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(
        M, hh, ww, c, ws.v, ws.y, sw.b3, sw.l3, gzn, gld, ws.gv, ws.gacc, ws.t3, bd);
  else
    coupling_bwd_kernel<false, BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(
        M, hh, ww, c, ws.v, ws.y, sw.b3, sw.l3, gzn, gld, ws.gv, ws.gacc, ws.t3, bd);
  GLOW_CHECK(cudaGetLastError());
  gy_kernel<BAND, V::tap><<<ceil_div(M * gy_ld, 256), 256, 0, stream>>>(M, hh, ww, cout, ws.gacc,
                                                                        ws.gy, bd);
  GLOW_CHECK(cudaGetLastError());

  // -- data gradients through the coupling net, on the wgmma/TMA core --------
  sm90::Args d3 = {};
  d3.M = M; d3.N = hidden; d3.K = 9 * cout;
  d3.logs = sw.a2l; d3.h = ws.h2; d3.out_bf16 = ws.ga2;
  d3.part_b = ws.part_a2b; d3.part_l = ws.part_a2l;
  GLOW_CHECK((sm90::gemm_nt<sm90::EPI_RELU_GRAD_BF16, V::rowsum>(d3, ws.gy, gy_ld, w3t, gy_ld,
                                                                 stream)));

  sm90::Args d2 = {};
  d2.M = M; d2.N = hidden; d2.K = hidden;
  d2.logs = sw.a1l; d2.h = ws.h1; d2.out_bf16 = ws.ga1;
  d2.part_b = ws.part_a1b; d2.part_l = ws.part_a1l;
  GLOW_CHECK((sm90::gemm_nt<sm90::EPI_RELU_GRAD_BF16, V::rowsum>(d2, ws.ga2, hidden, w2t, hidden,
                                                                 stream)));

  sm90::Args d1 = {};
  d1.M = M; d1.N = 9 * ch; d1.K = hidden; d1.out_f32 = ws.gp1;
  GLOW_CHECK((sm90::gemm_nt<sm90::EPI_F32>(d1, ws.ga1, hidden, w1t, hidden, stream)));

  // -- mix and actnorm ------------------------------------------------------
  gv1_kernel<BAND, V::tap><<<ceil_div(M * ch, 256), 256, 0, stream>>>(M, hh, ww, c, ws.gp1,
                                                                      ws.gv, bd);
  GLOW_CHECK(cudaGetLastError());
  MixArgs mb = {};  // g_u = W^T g_v, g_z = g_u * e^{anl}; u = (z + anb) * e^{anl} recomputed
  mb.M = M; mb.C = c; mb.a = ws.gv; mb.w = sw.wmat; mb.anb = sw.anb; mb.anl = sw.anl; mb.z = z;
  mb.out = gz; mb.u = ws.u; mb.gu = ws.gu;
  GLOW_CHECK(launch_mix_form<MIX_BWD>(mb, stream));

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

  GLOW_CHECK((weight_grad<V::accum>(M, hidden, hidden, ws.ga2, hidden, ws.h1, hidden, split,
                                    ws.part_w, g[6], stream)));
  if constexpr (V::staged)  // conv1 read the given patches: gW1 reads v's, with V::tap's taps
    GLOW_CHECK((stage_patches<BAND, V::tap>(M, hh, ww, c, ws.v, ws.p1, bd, stream)));
  GLOW_CHECK((weight_grad<V::accum>(M, hidden, 9 * ch, ws.ga1, hidden, ws.p1, p1_ld, split,
                                    ws.part_w, g[3], stream)));
  GLOW_CHECK((weight_grad<V::accum>(M, 9 * cout, hidden, ws.gy, gy_ld, ws.h2, hidden, split,
                                    ws.part_w, g[9], stream)));

  if constexpr (V::rowsum) {
    const int first = split / sm90::TM, parts = ceil_div(M, sm90::TM) - first;
    const size_t off = (size_t)first * hidden;
    GLOW_CHECK(reduce(parts, hidden, ws.part_a2b + off, 1.0f, g[7], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a2l + off, 1.0f, g[8], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a1b + off, 1.0f, g[4], stream));
    GLOW_CHECK(reduce(parts, hidden, ws.part_a1l + off, 1.0f, g[5], stream));
    GLOW_CHECK((col_sum<false, V::accum>(M, cout, split, ws.gacc, nullptr, 1.0f, ws.part_col,
                                         g[10], stream)));
    GLOW_CHECK((col_sum<false, V::accum>(M, cout, split, ws.t3, nullptr, 3.0f, ws.part_col,
                                         g[11], stream)));
    GLOW_CHECK((col_sum<false, V::accum>(M, c, split, gz, nullptr, 1.0f, ws.part_col, g[1],
                                         stream)));
    GLOW_CHECK((col_sum<true, V::accum>(M, c, split, ws.gu, ws.u, 1.0f, ws.part_col, g[2],
                                        stream)));
  } else {
    const int rowsums[] = {1, 2, 4, 5, 7, 8, 10, 11};
    for (int i : rowsums) GLOW_CHECK(zero(i));
  }

  GLOW_CHECK(outer_partials(M, c, split, ws.gv, ws.u, ws.part_col, stream));
  GLOW_CHECK((reduce_from<V::accum>(M, COL_CHUNK, split, c * c, ws.part_col, 1.0f, g[0], stream)));
  return cudaSuccess;
}

}  // namespace
