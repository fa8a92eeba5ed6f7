// One Glow flow step, forward and reverse, over row bands of the image, as
// a chain of hand-written kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel `pytorch_glow_tpu/ops/flowstep_pallas.py`
// `_make_kernel_halo` (K4, reached through `_step_raw_halo`).  Its plain
// PyTorch version is `step_forward_band_ref` / `step_reverse_band_ref` in
// `pytorch_glow_tpu_torch/ops/flowstep.py`, which also chooses the band
// height R and the bands per group G (`band_rows`, `bands_per_launch`).
//
// The TPU kernel cut an image into bands because one image's hidden
// activations overflowed VMEM.  Here the whole-image chain (flowstep.cu)
// stages h1, h2 and y of the whole batch in device memory, 2.2 GiB per call
// at the 128x128 level of celebahq256 with b=64, and indexes them in 32
// bits.  The band chain bounds both: it stages G bands at a time.
//
// Each band of R rows is staged with a 2-row halo above and below (two 3x3
// convs see 2 rows), as an (R+4)-row image (flowstep_common.cuh `Band`),
// and every tap masks on the absolute image row, so halo rows outside the
// image read as zero.  Per group of G bands:
//   gather_band        ext z, zero outside the image
//   mix_tile_kernel    (forward only) v = W @ ((z + b) * e^l) on ext
//   launch_net<band>   conv1's patches p1 (masked on absolute rows), then
//                      h1, h2 and the tap-packed y on ext, the three
//                      products on the wgmma/TMA core (gemm_sm90.cuh)
//   coupling_update    the R centre rows, per (pixel, channel): forward
//                      writes the output and one logdet partial per block
//                      of pixels; reverse writes a scratch
//   mix_tile_kernel    (reverse only) on the centre rows into the output
// then ld_sum adds each image's partials in band and block order.  No
// atomics.
//
// Slab form (spatial sharding, `pytorch_glow_tpu_torch/parallel/spatial.py`):
// the input is one rank's row slab of each image with 2 rows of each
// neighbouring rank's slab around it (`lead` = 2), `origin` the slab's
// first row in an image of `image` rows.  The bands cover the slab's own
// rows; taps mask on the absolute row, so the rows the exchange could not
// fill (above the image's first row, below its last) never count, and the
// logdet is the slab's partial, which the caller sums over the ranks.
//
// Bits: a centre row's p1, h1, h2, y and output come from the same values
// by the same code as in the whole chain (each product row runs over the
// same K slices in the same order inside one block, no split-K; the mix,
// the tap sum and the coupling are per pixel), so the z output equals the
// whole chain's bit for bit and decode(encode(x)) stays exact.  Only the
// logdet's sum order changes.
//
// What bounds it on this card: as the whole chain, operations (the
// coupling net's three products), plus (R+4)/R of them for the recomputed
// halo rows, 36/32 at the 128x128 level.  The products run on the core;
// every intermediate (p1, h1, h2, y, the staged and mixed z) still goes
// through device memory, as in the whole chain.

#include "flowstep_common.cuh"

extern "C" {

// One flow step over row bands.  z: (b*(hh + 2*lead)*ww, c) f32 input,
// left untouched: hh centre rows per image, lead rows above and below them
// (0, or 2 in the slab form), the first centre row being row `origin` of
// an image `image` rows high (0 and hh for whole images); R: band rows
// (divides hh); G: bands per group.  out: (same)
// f32 result.  ld: (b,) f32 coupling logdet (forward; zeros for additive).
// w1 padded to (hidden, padded(9*ch)).  Scratch for one group of G bands
// of (R+4)*ww staged pixels: zext and v (G*(R+4)*ww, c) f32 (v unused in
// reverse), p1 (.., padded(9*ch)) bf16, h1, h2 (.., hidden) bf16,
// y (.., 9*cout) f32, tmp (G*R*ww, c) f32 (reverse only), and ld_band
// (b*hh*ww,) f32, room for every band's logdet partials.  out and ld hold
// the centre rows only.  Returns 0 or the
// first launch's cudaError_t.
int glow_flowstep_band(int reverse, int affine, int b, int hh, int ww, int c, int hidden, int R,
                       int G, int lead, int origin, int image, const float* z, const float* wmat, const float* anb,
                       const float* anl, const void* w1, const float* a1b, const float* a1l,
                       const void* w2, const float* a2b, const float* a2l, const void* w3,
                       const float* b3, const float* l3, float* out, float* ld, float* zext,
                       float* v, void* p1, void* h1, void* h2, float* y, float* tmp,
                       float* ld_band, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int T = hh / R, nbands = b * T, ext_rows = R + 4;
  const int cout = affine ? c : c / 2;
  const StepWeights sw = {wmat, anb, anl, w1, a1b, a1l, w2, a2b, a2l, w3, b3, l3};
  for (int first = 0; first < nbands; first += G) {
    const int count = nbands - first < G ? nbands - first : G;
    const Band bd = {first, T, R, hh + 2 * lead, lead, origin, image};
    const int me = count * ext_rows * ww;
    GLOW_TRY(gather_band<false>(count, ww, c, bd, z, zext, stream));
    const float* src = zext;
    if (!reverse) {
      GLOW_TRY(launch_mix<false>(me, c, zext, wmat, anb, anl, v, stream));
      src = v;
    }
    GLOW_TRY(launch_net<true>(me, ext_rows, ww, c, hidden, cout, src, sw, p1, h1, h2, y, stream,
                              bd));
    if (!reverse) {
      GLOW_TRY((launch_coupling<true, false>(affine, count, ext_rows, ww, c, bd, src, y, b3, l3,
                                             out, nullptr, ld_band, stream)));
    } else {
      GLOW_TRY((launch_coupling<true, true>(affine, count, ext_rows, ww, c, bd, src, y, b3, l3,
                                            tmp, nullptr, nullptr, stream)));
      GLOW_TRY(launch_mix<true>(count * R * ww, c, tmp, wmat, anb, anl,
                                out + (size_t)first * R * ww * c, stream));
    }
  }
  if (!reverse)
    GLOW_TRY(ld_sum(b, affine ? T * coupling_parts(R * ww, c) : 0, ld_band, ld, stream));
  return 0;
}

}  // extern "C"
