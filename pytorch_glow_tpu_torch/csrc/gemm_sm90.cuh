// One GEMM core for Hopper (sm_90a): bf16 operands brought into shared
// memory by TMA, a warpgroup `wgmma.mma_async` into f32 registers, and the
// epilogues of the flow step's coupling net (flowstep_common.cuh
// `launch_net`: conv1, conv2 and conv3 of the forward, the reverse and the
// backward's recompute) and of its backward chain (flowstep_bwd_common.cuh
// `backward_chain`: the six gradient products).
//
// Block tile TM x TN = 128 x 128, reduction slices of TK = 64 (one
// 128-byte swizzle row of bf16).  Two consumer warpgroups each own 64 rows
// of the tile and run m64n128k16 on them; one thread of a ninth warp
// issues the TMA loads into a ring of STAGES slices, each marked full by
// an mbarrier with its transaction bytes and released by the two
// consumers through a second mbarrier.  The consumers keep one wgmma group
// in flight and release a slice once the group that read it has retired.
// The epilogue stages the tile in the freed slices, so that its global
// reads and writes are whole rows.  Two blocks fit an SM (shared memory
// and registers), so one block's epilogue overlaps the other's loads and
// products.
//
// Two operand orders, through the descriptors' transpose bits:
//   TRANS = false  C (M, N) = A (M, K) . B (N, K)^T, both K-major
//                  (`gemm_nt`): the coupling net's three products, a
//                  pixel-major activation times a weight, and the data
//                  gradients, a pixel-major cotangent times a transposed
//                  weight.  Each block sums all of K for its tile, slice
//                  by slice in order, so an output row's value does not
//                  depend on where the row falls (no split-K): the band
//                  chain's centre rows equal the whole chain's, and the
//                  backward's recompute equals the forward, bit for bit.
//   TRANS = true   C (M, N) = A (K, M)^T . B (K, N), both MN-major: the
//                  "K = M" weight gradients, read straight from the
//                  pixel-major (pixels, M) and (pixels, N) tensors, no
//                  transpose copy.  The reduction runs over one chunk of
//                  pixels per blockIdx.z (split-K), each chunk's product
//                  written as an f32 partial; the caller sums the
//                  partials in chunk order.
// TMA zero-fills whatever a box reads past the tensor's bounds, so ragged
// M, N and K need no masking on the load side; every store is masked.
// Global row strides must be multiples of 16 bytes (8 bf16): callers pad
// narrow rows to a multiple of 8 columns.
//
// Epilogues:
//   EPI_PARTIAL_F32        part[chunk, m, n] = C (TRANS only)
//   EPI_RELU_GRAD_BF16     C is the cotangent of h = relu(a_n) with
//                          a_n = (a + b) * e^l: g_an = C where h > 0, out =
//                          bf16(g_an * e^l), and per 128-row block the f32
//                          column partials of g_an * e^l and g_an * h
//                          (ROWSUM; one row per blockIdx.x, summed in a
//                          fixed order); N a multiple of 8
//   EPI_F32                out[m, n] = C
//   EPI_ACTNORM_RELU_BF16  out = bf16(max((C + b[n]) * e^{l[n]}, 0)), the
//                          conv actnorm and ReLU of the coupling net;
//                          N a multiple of 8
// No float atomics: two launches on the same inputs give the same bits.
//
// The tensor maps come from cuTensorMapEncodeTiled, fetched through the
// runtime's driver entry point (no link against libcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sm90 {

constexpr int TM = 128, TN = 128, TK = 64;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;            // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int BOX_BYTES = 64 * TK * 2;    // a 64 x 64 bf16 box, 8 KB
constexpr int SLICE_BYTES = TM * TK * 2;  // one operand's slice, 16 KB (TM == TN)
constexpr int CS_LD = TN + 8;             // the staged f32 tile's row stride
constexpr int SMEM_BYTES = 1024 + 2 * STAGES * SLICE_BYTES + 2 * STAGES * 8;
constexpr int TARGET_BLOCKS = 264;        // two blocks per SM, one wave
static_assert((TM * CS_LD + 2 * 16 * TN) * 4 <= 2 * STAGES * SLICE_BYTES,
              "the epilogue's tile and column partials fit in the slices");

enum Epi { EPI_PARTIAL_F32 = 0, EPI_RELU_GRAD_BF16 = 1, EPI_F32 = 2, EPI_ACTNORM_RELU_BF16 = 3 };

struct Args {
  int M, N, K;                  // C is (M, N); the reduction runs over K
  int chunk, split;             // TRANS: K per partial (a multiple of TK), see `chunk_range`
  const float* bias;            // EPI_ACTNORM_RELU_BF16: (N,)
  const float* logs;            // EPI_RELU_GRAD_BF16, EPI_ACTNORM_RELU_BF16: (N,)
  const __nv_bfloat16* h;       // EPI_RELU_GRAD_BF16: the ReLU output (M, N)
  __nv_bfloat16* out_bf16;      // EPI_RELU_GRAD_BF16, EPI_ACTNORM_RELU_BF16: (M, N)
  float* out_f32;               // EPI_F32: (M, N); EPI_PARTIAL_F32: (chunks, M, N)
  float* part_b;                // EPI_RELU_GRAD_BF16: (ceil(M / TM), N) partials
  float* part_l;                //   of sum g_an * e^l and of sum g_an * h
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Chunks of `chunk` pixels over [0, split) and again over [split, total):
// with split = 0 the plain chunking; a split marks a boundary that a
// variant sums from (csrc/anatomy.cu no_accum).
__host__ __device__ __forceinline__ int chunk_count(int total, int chunk, int split) {
  return cdiv(split, chunk) + cdiv(total - split, chunk);
}

__host__ __device__ __forceinline__ void chunk_range(int z, int total, int chunk, int split,
                                                     int* begin, int* end) {
  const int first = cdiv(split, chunk);
  if (z < first) {
    *begin = z * chunk;
    *end = *begin + chunk < split ? *begin + chunk : split;
  } else {
    *begin = split + (z - first) * chunk;
    *end = *begin + chunk < total ? *begin + chunk : total;
  }
}

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box at (c0 inner, c1 outer) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 f32 per thread) += A (64 x 16) * B (16 x 128), both read from
// shared memory through their descriptors.  TRANS sets both transpose bits
// (both operands MN-major), else both are K-major.
template <bool TRANS>
__device__ __forceinline__ void mma_64x128x16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS ? 1 : 0));
}

// -- the kernel -------------------------------------------------------------

// Shared-memory slices.  K-major (TRANS = false): one 64 x 128 box per
// operand, row r of the tile at byte r * 128, so warpgroup w's 64 rows
// start at w * BOX_BYTES and the k16 step kk at kk * 32 bytes; 8-row
// groups 1024 bytes apart (SBO).  MN-major (TRANS = true): two 64 x 64
// boxes per operand, box j holding tile columns j*64 .. j*64+63 for the 64
// k rows, row k at byte k * 128, so warpgroup w's A starts at
// w * BOX_BYTES, B's second 64-wide half is BOX_BYTES on (LBO), 8-k-row
// groups are 1024 bytes apart (SBO) and the k16 step is 2048 bytes.
template <bool TRANS, int EPI, bool ROWSUM = true>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Args g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the slices to it.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = base;
  uint8_t* sb = base + STAGES * SLICE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sb + STAGES * SLICE_BYTES);  // full[S], empty[S]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);

  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  int k_begin = 0, k_end = g.K;
  if (TRANS) chunk_range(blockIdx.z, g.K, g.chunk, g.split, &k_begin, &k_end);
  const int iters = cdiv(k_end - k_begin, TK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * SLICE_BYTES);
        const uint32_t a = smem_u32(sa + s * SLICE_BYTES), b = smem_u32(sb + s * SLICE_BYTES);
        const int k0 = k_begin + it * TK;
        if (TRANS) {
          tma_load(a, &map_a, row0, k0, full);
          tma_load(a + BOX_BYTES, &map_a, row0 + 64, k0, full);
          tma_load(b, &map_b, col0, k0, full);
          tma_load(b + BOX_BYTES, &map_b, col0 + 64, k0, full);
        } else {
          tma_load(a, &map_a, k0, row0, full);
          tma_load(b, &map_b, k0, col0, full);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns tile rows wg*64 .. wg*64+63 -------------
  const int wg = threadIdx.x / 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  const uint32_t a0 = smem_u32(sa) + wg * BOX_BYTES, b0 = smem_u32(sb);
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint64_t da, db;
      if (TRANS) {
        da = smem_desc(a0 + s * SLICE_BYTES + kk * 2048, BOX_BYTES, 1024);
        db = smem_desc(b0 + s * SLICE_BYTES + kk * 2048, BOX_BYTES, 1024);
      } else {
        da = smem_desc(a0 + s * SLICE_BYTES + kk * 32, 16, 1024);
        db = smem_desc(b0 + s * SLICE_BYTES + kk * 32, 16, 1024);
      }
      mma_64x128x16<TRANS>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of slice it-1 has retired
    fence_acc(d);
    if (it > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(d);

  // -- epilogue: the tile into shared memory (the slices are free once
  // both warpgroups' products have retired; every load issued was waited
  // for), then out by whole rows.  d[i] is C at tile row
  // wg*64 + warp*16 + lane/4 + 8*((i>>1)&1), column 8*(i>>2) + 2*(lane%4) + (i&1).
  float* cs = reinterpret_cast<float*>(base);  // [TM][CS_LD]
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(cs + r * CS_LD + c) = make_float2(d[i], d[i + 1]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const int t = threadIdx.x;

  if constexpr (EPI == EPI_PARTIAL_F32 || EPI == EPI_F32) {
    float* out = g.out_f32 + (EPI == EPI_PARTIAL_F32 ? (size_t)blockIdx.z * g.M * g.N : 0);
    for (int u = t; u < TM * TN; u += CONSUMERS) {
      const int r = u / TN, c = u % TN;
      if (row0 + r < g.M && col0 + c < g.N)
        out[(size_t)(row0 + r) * g.N + col0 + c] = cs[r * CS_LD + c];
    }
  } else if constexpr (EPI == EPI_ACTNORM_RELU_BF16) {
    // Thread t owns the 8 columns c8 .. c8+7 (N is a multiple of 8) of
    // rows t/16, t/16 + 16, ...: 16-byte vectors of h out, each element
    // (C + b) * e^l in f32, then the ReLU and the bf16 cast.
    const int c8 = (t % 16) * 8, col = col0 + c8;
    if (col < g.N) {
      float bias[8], el[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bias[e] = g.bias[col + e];
        el[e] = expf(g.logs[col + e]);
      }
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        const int r = t / 16 + 16 * i;
        if (row0 + r >= g.M) break;
        const float4 c_lo = *reinterpret_cast<const float4*>(cs + r * CS_LD + c8);
        const float4 c_hi = *reinterpret_cast<const float4*>(cs + r * CS_LD + c8 + 4);
        const float cv[8] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
        uint4 ov;
        __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ob[e] = __float2bfloat16(fmaxf((cv[e] + bias[e]) * el[e], 0.0f));
        *reinterpret_cast<uint4*>(g.out_bf16 + (size_t)(row0 + r) * g.N + col) = ov;
      }
    }
  } else {
    // Thread t owns the 8 columns c8 .. c8+7 (N is a multiple of 8, so
    // they are in or out whole) of rows t/16, t/16 + 16, ...: 16-byte
    // vectors of h in and of g_a out.
    const int c8 = (t % 16) * 8, col = col0 + c8;
    const bool col_ok = col < g.N;
    float el[8], sum_b[8], sum_l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      el[e] = col_ok ? expf(g.logs[col + e]) : 0.0f;
      sum_b[e] = 0.0f;
      sum_l[e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < TM / 16; ++i) {
      const int r = t / 16 + 16 * i;
      if (!col_ok || row0 + r >= g.M) continue;
      const size_t off = (size_t)(row0 + r) * g.N + col;
      const uint4 hv = *reinterpret_cast<const uint4*>(g.h + off);
      const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&hv);
      const float4 c_lo = *reinterpret_cast<const float4*>(cs + r * CS_LD + c8);
      const float4 c_hi = *reinterpret_cast<const float4*>(cs + r * CS_LD + c8 + 4);
      const float cv[8] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
      uint4 ov;
      __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float hf = __bfloat162float(hb[e]);
        const float gn = hf > 0.0f ? cv[e] : 0.0f;
        ob[e] = __float2bfloat16(gn * el[e]);
        sum_b[e] += gn * el[e];
        sum_l[e] += gn * hf;
      }
      *reinterpret_cast<uint4*>(g.out_bf16 + off) = ov;
    }
    if constexpr (ROWSUM) {
      // Per column: this thread's 8 rows in row order, then the 16 row
      // groups in order.
      float* red = cs + TM * CS_LD;  // [2][16][TN]
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[(t / 16) * TN + c8 + e] = sum_b[e];
        red[16 * TN + (t / 16) * TN + c8 + e] = sum_l[e];
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      const int c = t % TN, which = t / TN;  // which 0: sum g_an * e^l, 1: sum g_an * h
      if (col0 + c < g.N) {
        const float* src = red + which * 16 * TN + c;
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 16; ++k) s += src[k * TN];
        (which == 0 ? g.part_b : g.part_l)[(size_t)blockIdx.x * g.N + col0 + c] = s;
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled through the runtime's driver entry point, or null.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D bf16 tensor map over `outer` rows of `inner` elements, rows `ld`
// elements apart, read in boxes of box_inner x box_outer with the 128-byte
// swizzle; reads past the bounds fill zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int ld,
                            int box_inner, int box_outer) {
  if (((uintptr_t)ptr & 15) != 0 || ld % 8 != 0 || inner > ld) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool TRANS, int EPI, bool ROWSUM>
cudaError_t launch(const Args& g, const CUtensorMap& ma, const CUtensorMap& mb, dim3 grid,
                   cudaStream_t stream) {
  auto kernel = gemm_kernel<TRANS, EPI, ROWSUM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mb, g);
  return cudaGetLastError();
}

// C (M, N) = A (M, K) . B (N, K)^T with the epilogue EPI (EPI_F32, or
// EPI_RELU_GRAD_BF16 or EPI_ACTNORM_RELU_BF16, which need N a multiple of
// 8); A and B row-major with row strides lda, ldb elements (multiples of
// 8).  No split-K: each block sums all of K, in order.
template <int EPI, bool ROWSUM = true>
cudaError_t gemm_nt(const Args& g, const void* a, int lda, const void* b, int ldb,
                    cudaStream_t stream) {
  static_assert(EPI != EPI_PARTIAL_F32, "partials are the weight gradients'");
  if (EPI != EPI_F32 && g.N % 8 != 0) return cudaErrorInvalidValue;
  if (g.M == 0) return cudaSuccess;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, g.K, g.M, lda, TK, TM);
  if (err == cudaSuccess) err = make_map(&mb, b, g.K, g.N, ldb, TK, TN);
  if (err != cudaSuccess) return err;
  return launch<false, EPI, ROWSUM>(g, ma, mb, dim3(cdiv(g.M, TM), cdiv(g.N, TN)), stream);
}

// Pixels per weight-gradient partial: enough chunks that the grid about
// fills one wave of TARGET_BLOCKS blocks, but none under MIN_CHUNK pixels
// (a block's load pipeline needs a few slices to fill); a multiple of TK.
constexpr int MIN_CHUNK = 16 * TK;

inline int wgrad_chunk(int pixels, int m, int n) {
  const int tiles = cdiv(m, TM) * cdiv(n, TN);
  int chunks = TARGET_BLOCKS / tiles;
  chunks = chunks < cdiv(pixels, MIN_CHUNK) ? chunks : cdiv(pixels, MIN_CHUNK);
  chunks = chunks > 1 ? chunks : 1;
  const int chunk = cdiv(cdiv(pixels, chunks), TK) * TK;
  return chunk > TK ? chunk : TK;
}

// part[z] = A (K, M)^T . B (K, N) over pixel chunk z of `chunk` (a
// multiple of TK) with the given split, z in [0, chunk_count): A and B
// row-major with row strides lda, ldb elements (multiples of 8).
inline cudaError_t weight_grad_partials(int pixels, int m, int n, const void* a, int lda,
                                        const void* b, int ldb, int chunk, int split,
                                        float* part, cudaStream_t stream) {
  if (chunk % TK != 0 || split % TK != 0 || split > pixels) return cudaErrorInvalidValue;
  if (pixels == 0) return cudaSuccess;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, m, pixels, lda, 64, TK);
  if (err == cudaSuccess) err = make_map(&mb, b, n, pixels, ldb, 64, TK);
  if (err != cudaSuccess) return err;
  Args g = {};
  g.M = m;
  g.N = n;
  g.K = pixels;
  g.chunk = chunk;
  g.split = split;
  g.out_f32 = part;
  const dim3 grid(cdiv(m, TM), cdiv(n, TN), chunk_count(pixels, chunk, split));
  return launch<true, EPI_PARTIAL_F32, true>(g, ma, mb, grid, stream);
}

}  // namespace sm90
}  // namespace
