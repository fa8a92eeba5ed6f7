// The LU-parameterised invertible 1x1 convolution as hand-written kernels
// for Hopper (sm_90a): the weight build and the channel mix over a pixel
// batch, both in plain f32 on the CUDA cores.
//
// Replaces the TPU kernels of `pytorch_glow_tpu/ops/invconv_pallas.py`:
//   * K6a, `_pallas_fused_raw` (body `_fwd_kernel`): builds
//     W = P L (U + diag(sign_s e^log_s)) once into VMEM scratch in grid
//     step 0, then y = x W^T over 1024-row tiles.
//   * K6b, `_pallas_plain_raw` (body `_matmul_kernel`): y = x W^-T with
//     W^-1 from two triangular solves outside the kernel.
// Their plain PyTorch versions are `lu_assemble`, `lu_inverse` and
// `mix_channels` in `pytorch_glow_tpu_torch/ops/invconv.py`; the wrappers,
// and the chooser between the two paths below (`mix_path`), are
// `pytorch_glow_tpu_torch/ops/invconv_fused.py`.
//
// Precision: the TPU kernel multiplies at HIGHEST, and the exact round-trip
// and the NLL depend on the mix, so every product here is an f32 FMA on
// the CUDA cores.  Each output starts at 0 and adds fmaf(x[n, i], w[j, i])
// with i ascending, on both paths, so they give the same bits on the same
// W.  No TF32, no tensor cores.
//
// What bounds it on this card: max(4 (2NC + C^2) B / 3.35 TB/s,
// 2NC^2 / 67 TFLOP/s).  At C <= 48 (every cifar10 level, celeba64's first
// three) the bytes bound it: x is read once and y written once, 0.5 C FLOP
// per byte; at the cifar10 shapes the bound is 0.5-1.9 us, under the cost
// of a launch.  Two paths:
//
//   narrow (C in {12, 24, 48}, x 16-byte aligned): one persistent launch,
//     `narrow_kernel<C>`.  A block stages W^T in shared memory once -- for
//     K6a it builds W there from the LU factors, so K6a is one launch too
//     -- then walks its row tiles (128 / (C / 12) rows, 6 KB) through a
//     3-stage ring that one thread fills with 1-D TMA bulk copies
//     (`cp.async.bulk` completing on an mbarrier; a row is C * 4 bytes, a
//     multiple of 16, so a ragged last tile copies too).  Each row is
//     split over C / 12 neighbouring threads, each owning 12 outputs: 12 C
//     FMAs a thread, the x row read from the ring (the row's threads read
//     the same addresses) and W^T as float4s whose address is the same in
//     every row, so the reads broadcast.  Stores are 16-byte.  The tile
//     loads of the first stages are issued before the W build, so the
//     build overlaps them; block 0 writes W out for the backward.  K6a's
//     build (`build_w`) is a small register-tiled product of the staged
//     factors, 4 x 4 elements a thread over the triangle each tile needs,
//     each in `build_kernel`'s order; the factors come in through one
//     batch of loads (`stage_factors`).  Every block builds its own W: a
//     thread-block cluster sharing one build through distributed shared
//     memory measured slower on the card (PERF.md).
//   tiled (every other C): a simple tiled SGEMM, `mix_kernel`, 64x64
//     output tiles, x and W staged in shared memory 16 input channels at a
//     time with coalesced loads, 4x4 outputs per thread in registers; the
//     ragged row, column and channel edges load zeros (adding an exact zero
//     changes no sum).  For K6a, `build_kernel` writes W first, one launch
//     before.  At C >= ~140 the f32 FMAs would bound it; wide C is later
//     work (6 % of the f32 bound at 1024x384).

#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

// -- the tiled path -----------------------------------------------------------

constexpr int BM = 64;   // rows (pixels) per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels staged per pass
constexpr int TX = 16;   // threads along the output channels
constexpr int TY = 16;   // threads along the rows
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;  // rows per thread
constexpr int RN = BN / TX;  // output channels per thread
constexpr int BUILD_THREADS = 256;

// W[i, j] = sum_k L[r, k] U'[k, j] with r = p[i], L unit lower, U' =
// triu(U, 1) + diag(sign e^log_s); one thread per element, k ascending.
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

cudaError_t launch_tiled(int n, int c, const float* x, const float* w, float* y,
                         cudaStream_t stream) {
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)((c + BN - 1) / BN));
  mix_kernel<<<grid, THREADS, 0, stream>>>(n, c, x, w, y);
  return cudaGetLastError();
}

// -- the narrow path ----------------------------------------------------------

constexpr int NARROW_THREADS = 128;
constexpr int NARROW_STAGES = 3;
constexpr int JG = 12;                                 // outputs per thread
constexpr int TILE_FLOATS = NARROW_THREADS * JG;       // rows per tile x C, 6 KB

struct NarrowArgs {
  int n;
  const float* x;
  float* y;
  const float* w;        // K6b: the weight, (C, C)
  const int64_t* p_idx;  // K6a: the LU factors (strict triangles of l_raw, u_raw read)
  const float* l_raw;
  const float* u_raw;
  const float* log_s;
  const float* sign_s;
  float* w_out;          // K6a: receives W, (C, C)
};

template <int C, bool BUILD>
struct NarrowSmem {
  alignas(128) float ring[NARROW_STAGES][TILE_FLOATS];
  alignas(16) float wt[C * C];             // wt[i * C + j] = W[j, i]
  float lt[BUILD ? C * C : 1];              // K6a: L~, row-major
  alignas(16) float ut[BUILD ? C * C : 1];  //      U~, row-major
  int pinv[BUILD ? C : 1];                  //      pinv[p[i]] = i
  uint64_t full[NARROW_STAGES];
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Brings the C x C factors l_raw (m = 0) and u_raw (m = 1) from global
// memory through registers, calling put(m, e, value) for each element e:
// every load issued before the first store, so the block waits for one
// round trip instead of one per element.
template <int C, typename Put>
__device__ __forceinline__ void stage_factors(const float* l_raw, const float* u_raw, Put put) {
  constexpr int PER = (C * C + NARROW_THREADS - 1) / NARROW_THREADS;
  const float* const src[2] = {l_raw, u_raw};
  float v[2][PER];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = (int)threadIdx.x + q * NARROW_THREADS;
      v[m][q] = e < C * C ? __ldg(src[m] + e) : 0.0f;
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = (int)threadIdx.x + q * NARROW_THREADS;
      if (e < C * C) put(m, e, v[m][q]);
    }
}

// W^T from the staged factors (`narrow_kernel`), one 4 x 4 tile of A =
// L~ U~ at a time per thread, into the block's shared W^T `wt` (W = P A:
// A's row r is W's row pinv[r]).  Tile t = (tr, tj): A[r, j] for r in
// [4 tr, +4), j in [4 tj, +4)
// is the sum over k < 4 min(tr, tj) + 4 of fmaf(L~[r, k], U~[k, j]) in
// ascending k, which covers k <= min(r, j).  That is `build_kernel`'s
// sum: the terms past min(r, j) multiply an exact zero of L~ or U~ and
// change no sum (beyond the sign of a zero), so W has its bits.  Where
// `w_out` is given, the tile's rows of W go there too.
template <int C>
__device__ __forceinline__ void build_w(const float* lt, const float* ut, const int* pinv,
                                        float* wt, float* w_out) {
  constexpr int T4 = C / 4;
  const float4* ut4 = reinterpret_cast<const float4*>(ut);
  for (int t = (int)threadIdx.x; t < T4 * T4; t += NARROW_THREADS) {
    const int tr = t / T4, tj = t % T4;
    const int kend = 4 * min(tr, tj) + 4;
    const float* lrow = lt + 4 * tr * C;
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
    for (int k0 = 0; k0 < kend; k0 += 4) {
#pragma unroll
      for (int k = k0; k < k0 + 4; ++k) {
        const float4 u4 = ut4[k * T4 + tj];
        const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float l = lrow[m * C + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(l, u[q], acc[m][q]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = pinv[4 * tr + m];
#pragma unroll
      for (int q = 0; q < 4; ++q) wt[(4 * tj + q) * C + i] = acc[m][q];
      if (w_out != nullptr)
        *reinterpret_cast<float4*>(w_out + i * C + 4 * tj) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// y = x W^T over rows [0, n), W^T staged from `w` (K6b) or built from the
// LU factors (K6a, BUILD).
template <int C, bool BUILD>
__global__ void __launch_bounds__(NARROW_THREADS) narrow_kernel(const NarrowArgs a) {
  static_assert(C % JG == 0 && NARROW_THREADS % (C / JG) == 0, "C is 12, 24 or 48");
  constexpr int TPR = C / JG;                 // threads per row
  constexpr int ROWS = NARROW_THREADS / TPR;  // rows per tile
  __shared__ NarrowSmem<C, BUILD> s;
  const int tid = threadIdx.x;
  const int tiles = (a.n + ROWS - 1) / ROWS;
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;

  auto issue = [&](int it) {  // tile blockIdx.x + it * gridDim.x into stage it % STAGES
    const int tile = blockIdx.x + it * gridDim.x;
    const int rows = min(ROWS, a.n - tile * ROWS);
    const uint32_t bytes = (uint32_t)rows * C * 4;
    const uint32_t bar = sm90::smem_u32(&s.full[it % NARROW_STAGES]);
    sm90::mbar_expect_tx(bar, bytes);
    bulk_load(sm90::smem_u32(s.ring[it % NARROW_STAGES]), a.x + (int64_t)tile * ROWS * C, bytes,
              bar);
  };

  if (tid == 0) {
    for (int st = 0; st < NARROW_STAGES; ++st) sm90::mbar_init(sm90::smem_u32(&s.full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < NARROW_STAGES && it < mine; ++it) issue(it);
  }

  // W^T into shared memory.
  if constexpr (BUILD) {
    // The factors with their implied entries written out: L~ = tril(l_raw,
    // -1) + I and U~ = triu(u_raw, 1) + diag(sign_s e^log_s), row-major,
    // and p's inverse.  The diagonal's and p's loads go out with the
    // factors'.
    int pi = 0;
    float ls = 0.0f, sg = 0.0f;
    if (tid < C) {
      pi = (int)__ldg(a.p_idx + tid);
      ls = __ldg(a.log_s + tid);
      sg = __ldg(a.sign_s + tid);
    }
    stage_factors<C>(a.l_raw, a.u_raw, [&](int m, int e, float v) {
      const int row = e / C, col = e % C;
      if (m == 0) s.lt[e] = col < row ? v : (col == row ? 1.0f : 0.0f);
      else if (row != col) s.ut[e] = row < col ? v : 0.0f;
    });
    if (tid < C) {
      s.pinv[pi] = tid;
      s.ut[tid * (C + 1)] = sg * expf(ls);  // as in `build_kernel`
    }
    __syncthreads();
    build_w<C>(s.lt, s.ut, s.pinv, s.wt, blockIdx.x == 0 ? a.w_out : nullptr);
  } else {
    // W^T by 4 x 4 blocks through registers: neighbouring threads take
    // neighbouring block rows of W, so their float4 stores of W^T's rows
    // fall on neighbouring banks.
    constexpr int T4 = C / 4;
    for (int b = tid; b < T4 * T4; b += NARROW_THREADS) {
      const int bi = b % T4, bj = b / T4;
      float v[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[m][q] = __ldg(a.w + (4 * bi + m) * C + 4 * bj + q);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(s.wt + (4 * bj + q) * C + 4 * bi) =
            make_float4(v[0][q], v[1][q], v[2][q], v[3][q]);
    }
  }
  __syncthreads();

  const int r = tid / TPR, g = tid % TPR;  // this thread's row of the tile, output group
  const float4* wt4 = reinterpret_cast<const float4*>(s.wt) + g * (JG / 4);
  for (int it = 0; it < mine; ++it) {
    const int st = it % NARROW_STAGES;
    const int64_t row = (int64_t)(blockIdx.x + it * gridDim.x) * ROWS + r;
    sm90::mbar_wait(sm90::smem_u32(&s.full[st]), (uint32_t)(it / NARROW_STAGES) & 1u);
    if (row < a.n) {
      float xr[C];
      const float4* x4 = reinterpret_cast<const float4*>(s.ring[st] + r * C);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 v = x4[q];
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
      float acc[JG];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) acc[jj] = 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int q = 0; q < JG / 4; ++q) {
          const float4 w = wt4[i * (C / 4) + q];
          acc[4 * q] = fmaf(xr[i], w.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(xr[i], w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xr[i], w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xr[i], w.w, acc[4 * q + 3]);
        }
      }
      float4* y4 = reinterpret_cast<float4*>(a.y + row * C + g * JG);
#pragma unroll
      for (int q = 0; q < JG / 4; ++q)
        y4[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    // Every thread is done with this stage before it is refilled.
    __syncthreads();
    if (tid == 0 && it + NARROW_STAGES < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + NARROW_STAGES);
    }
  }
}

// The grid: one tile per block up to what the card holds at once, at most
// `max_blocks` (blocks per SM times SMs, read once).
template <int C, bool BUILD>
cudaError_t launch_narrow(const NarrowArgs& args, cudaStream_t stream) {
  constexpr int ROWS = NARROW_THREADS / (C / JG);
  static int max_blocks = 0;
  auto kernel = narrow_kernel<C, BUILD>;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NARROW_THREADS, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (args.n + ROWS - 1) / ROWS;
  const int grid = tiles < max_blocks ? tiles : max_blocks;
  kernel<<<grid, NARROW_THREADS, 0, stream>>>(args);
  return cudaGetLastError();
}

template <bool BUILD>
cudaError_t dispatch_narrow(int c, const NarrowArgs& args, cudaStream_t stream) {
  switch (c) {
    case 12: return launch_narrow<12, BUILD>(args, stream);
    case 24: return launch_narrow<24, BUILD>(args, stream);
    case 48: return launch_narrow<48, BUILD>(args, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K6a.  x, y: (n, c) f32; p_idx (c,) int64; l_raw, u_raw (c, c) f32 (only
// the strict lower / upper parts are read); log_s, sign_s (c,) f32;
// w: (c, c) f32 that receives W.  narrow: 1 for the one-launch narrow path
// (c in {12, 24, 48}, x and w 16-byte aligned), 0 for the build-plus-tiled
// pair.  Returns 0 or the first failing call's cudaError_t.
int glow_invconv_forward(int n, int c, int narrow, const float* x,
                         const int64_t* p_idx, const float* l_raw, const float* u_raw,
                         const float* log_s, const float* sign_s, float* w, float* y,
                         void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (narrow) {
    const NarrowArgs args{n, x, y, nullptr, p_idx, l_raw, u_raw, log_s, sign_s, w};
    return (int)dispatch_narrow<true>(c, args, stream);
  }
  const int64_t elems = (int64_t)c * c;
  build_kernel<<<(unsigned)((elems + BUILD_THREADS - 1) / BUILD_THREADS), BUILD_THREADS, 0,
                 stream>>>(c, p_idx, l_raw, u_raw, log_s, sign_s, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_tiled(n, c, x, w, y, stream);
}

// K6b.  x, y: (n, c) f32; w: (c, c) f32 (W^-1).  y = x w^T, on the narrow
// path (narrow = 1) or the tiled one.
int glow_invconv_mix(int n, int c, int narrow, const float* x, const float* w, float* y,
                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (narrow) {
    const NarrowArgs args{n, x, y, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    return (int)dispatch_narrow<false>(c, args, stream);
  }
  return (int)launch_tiled(n, c, x, w, y, stream);
}

}  // extern "C"
