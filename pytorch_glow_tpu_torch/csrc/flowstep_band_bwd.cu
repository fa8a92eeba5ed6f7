// The Glow flow step's backward over row bands of the image, for Hopper
// (sm_90a): recompute, then the cotangents of z and of all 12 packed
// weights, band by band.
//
// Replaces the TPU kernel `pytorch_glow_tpu/ops/flowstep_pallas.py`
// `_make_bwd_kernel_halo` (K5, reached through `_bwd_raw_halo`).  Its plain
// PyTorch version is `step_backward_band_ref` in
// `pytorch_glow_tpu_torch/ops/flowstep.py`.
//
// The whole-image backward (flowstep_bwd.cu) stages 13 full-size
// intermediates, about 4.8 GiB per call at the 128x128 level of celebahq256
// with b=64.  This chain stages G bands at a time, each an (R+4)-row image
// with a 2-row halo (flowstep_common.cuh `Band`).  Per group of G bands:
//   gather_band        ext z (zero outside the image) and ext g_zn (zero
//                      on the halo rows too: those outputs belong to the
//                      neighbouring bands, which backpropagate them)
//   backward_chain     K3's chain (flowstep_bwd_common.cuh) on the staged
//                      bands: recompute with K4's own `launch_net`, so the
//                      ReLU masks agree bit for bit, its staged patches
//                      kept for gW1; taps and their transposes masked on
//                      absolute rows; g_ld on centre rows only.  Weight
//                      grads go to this group's slot.
//   scatter_band       each band's ext g_z: centre rows to g_z, the two top
//                      and two bottom halo rows to per-band buffers
// then fold_band adds to each pixel its neighbour band's halo rows (a band
// of R >= 4 rows has at most one neighbour per pixel; halo rows outside the
// image, across an image boundary, are never added), and one reduction per
// weight grad sums the group slots in group order.  No float atomics: two
// launches on the same inputs give the same bits.
//
// What bounds it on this card: as K3, operations, plus (R+4)/R of them for
// the recomputed halo rows.  All nine products (the recompute's three,
// K4's own, and the six gradient products) run on K3's wgmma/TMA core
// (gemm_sm90.cuh).

#include "flowstep_bwd_common.cuh"

namespace {

// ext g_z of the staged bands -> centre rows into gz (b*hh*ww, c); rows 0,1
// into gtop and rows R+2, R+3 into gbot, each (nbands, 2*ww, c).
__global__ void scatter_band_kernel(int count, int ww, int c, Band bd, const float* ext,
                                    float* gz, float* gtop, float* gbot) {
  const int ext_rows = bd.rows + 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count * ext_rows * ww * c) return;
  const int ch = idx % c, px = idx / c;
  const int x = px % ww, r = px / ww;
  const int j = r / ext_rows, yy = r - j * ext_rows;
  const size_t band = (size_t)bd.first + j;
  const float val = ext[idx];
  if (yy < 2)
    gtop[(band * 2 * ww + yy * ww + x) * c + ch] = val;
  else if (yy >= bd.rows + 2)
    gbot[(band * 2 * ww + (yy - bd.rows - 2) * ww + x) * c + ch] = val;
  else
    gz[(band * bd.rows * ww + (size_t)(yy - 2) * ww + x) * c + ch] = val;
}

// gz[pixel] += the neighbouring band's halo rows over it, within the image:
// rows 0,1 of band t take band t-1's bottom halo, rows R-2, R-1 band t+1's
// top halo.
__global__ void fold_band_kernel(size_t total, int ww, int c, int R, int T, const float* gtop,
                                 const float* gbot, float* gz) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t px = idx / c;
  const int ch = (int)(idx % c);
  const int x = (int)(px % ww);
  const size_t band = px / ((size_t)R * ww);
  const int r = (int)(px / ww % R);
  const int t = (int)(band % T);
  if (r < 2 && t > 0)
    gz[idx] += gbot[((band - 1) * 2 * ww + r * ww + x) * c + ch];
  else if (r >= R - 2 && t < T - 1)
    gz[idx] += gtop[((band + 1) * 2 * ww + (r - R + 2) * ww + x) * c + ch];
}

// The band workspace: one group's chain workspace and ext buffers, the
// halo buffers of every band, and the per-group weight-grad slots.
struct BandWorkspace {
  Workspace chain;
  float *zext, *gext, *gzext, *gtop, *gbot;
  float* slot[N_WEIGHTS];  // (groups, n_i) each
  size_t bytes;
};

void weight_sizes(int c, int hidden, int cout, size_t* n) {
  const int ch = c / 2;
  const size_t sizes[N_WEIGHTS] = {(size_t)c * c, (size_t)c, (size_t)c,
                                   (size_t)hidden * 9 * ch, (size_t)hidden, (size_t)hidden,
                                   (size_t)hidden * hidden, (size_t)hidden, (size_t)hidden,
                                   (size_t)9 * cout * hidden, (size_t)cout, (size_t)cout};
  for (int i = 0; i < N_WEIGHTS; ++i) n[i] = sizes[i];
}

BandWorkspace carve_band(char* base, int b, int hh, int ww, int c, int hidden, int cout, int R,
                         int G) {
  const int nbands = b * (hh / R);
  const int groups = ceil_div(nbands, G);
  const size_t me = (size_t)G * (R + 4) * ww;
  Carver cv = {base, 0};
  BandWorkspace w = {};
  w.chain = carve(cv, (int)me, c, hidden, cout);
  w.zext = (float*)cv.take(me * c * 4);
  w.gext = (float*)cv.take(me * c * 4);
  w.gzext = (float*)cv.take(me * c * 4);
  w.gtop = (float*)cv.take((size_t)nbands * 2 * ww * c * 4);
  w.gbot = (float*)cv.take((size_t)nbands * 2 * ww * c * 4);
  size_t n[N_WEIGHTS];
  weight_sizes(c, hidden, cout, n);
  for (int i = 0; i < N_WEIGHTS; ++i) w.slot[i] = (float*)cv.take((size_t)groups * n[i] * 4);
  w.bytes = cv.off;
  return w;
}

}  // namespace

extern "C" {

// Bytes of scratch `glow_flowstep_band_bwd` needs for this shape, R and G.
size_t glow_flowstep_band_bwd_workspace(int affine, int b, int hh, int ww, int c, int hidden,
                                        int R, int G) {
  return carve_band(nullptr, b, hh, ww, c, hidden, affine ? c : c / 2, R, G).bytes;
}

// Backward of one forward flow step over row bands of R rows (R divides
// hh), G bands per group.  Operands as `glow_flowstep_bwd`.  Returns 0 or
// the first launch's cudaError_t.
int glow_flowstep_band_bwd(int affine, int b, int hh, int ww, int c, int hidden, int R, int G,
                           const float* z, const float* wmat, const float* anb, const float* anl,
                           const void* w1, const float* a1b, const float* a1l, const void* w2,
                           const float* a2b, const float* a2l, const void* w3, const float* b3,
                           const float* l3, const void* w1t, const void* w2t, const void* w3t,
                           const float* gzn, const float* gld, float* gz, float* g_wmat,
                           float* g_anb, float* g_anl, float* g_w1, float* g_a1b, float* g_a1l,
                           float* g_w2, float* g_a2b, float* g_a2l, float* g_w3, float* g_b3,
                           float* g_l3, void* workspace, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int T = hh / R, nbands = b * T, ext_rows = R + 4;
  const int cout = affine ? c : c / 2;
  const int groups = ceil_div(nbands, G);
  const BandWorkspace ws = carve_band((char*)workspace, b, hh, ww, c, hidden, cout, R, G);
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  float* const out[N_WEIGHTS] = {g_wmat, g_anb, g_anl, g_w1, g_a1b, g_a1l,
                                 g_w2,   g_a2b, g_a2l, g_w3, g_b3,  g_l3};
  size_t n[N_WEIGHTS];
  weight_sizes(c, hidden, cout, n);

  for (int group = 0; group < groups; ++group) {
    const int first = group * G;
    const int count = nbands - first < G ? nbands - first : G;
    const Band bd = {first, T, R, hh};
    const int me = count * ext_rows * ww;
    GLOW_TRY(gather_band<false>(count, ww, c, bd, z, ws.zext, stream));
    GLOW_TRY(gather_band<true>(count, ww, c, bd, gzn, ws.gext, stream));
    float* grads[N_WEIGHTS];
    for (int i = 0; i < N_WEIGHTS; ++i) grads[i] = ws.slot[i] + (size_t)group * n[i];
    GLOW_TRY(backward_chain<true>(affine, me, ext_rows, ww, c, hidden, bd, ws.zext, sw, w1t, w2t,
                                  w3t, ws.gext, gld, ws.gzext, grads, ws.chain, stream));
    scatter_band_kernel<<<ceil_div(me * c, 256), 256, 0, stream>>>(count, ww, c, bd, ws.gzext,
                                                                   gz, ws.gtop, ws.gbot);
    GLOW_TRY(cudaGetLastError());
  }

  const size_t total = (size_t)b * hh * ww * c;
  fold_band_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(total, ww, c, R, T,
                                                                         ws.gtop, ws.gbot, gz);
  GLOW_TRY(cudaGetLastError());
  for (int i = 0; i < N_WEIGHTS; ++i)
    GLOW_TRY(reduce(groups, (int)n[i], ws.slot[i], 1.0f, out[i], stream));
  return 0;
}

}  // extern "C"
