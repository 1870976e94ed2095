// Slot-splat assembly of the pose renderer: K4 (forward) and K5 (backward).
//
// K4 replaces the Pallas kernel genpc_tpu/render/splat_kernel.py::_fwd_kernel
// (through assemble): per output pixel, phase 0 folds dmax, the largest
// depth weight dn over the (2f+1)^2 window offsets x S slots of the padded
// slot table, counting entries that are present (sigma2 > 0), whose centre
// lies in the image and whose window holds the pixel; phase 1 sums
// w * rgb and w with w = exp(-d^2 / max(2 sigma2, 1e-12)) *
// exp(min((dn - dmax) / gamma, 0)), cut where the Gaussian factor is
// <= 1e-4.
//
// K5 replaces genpc_tpu/render/splat_kernel.py::_bwd_kernel (through
// assemble_bwd): the transpose of K4 as a gather.  Each table entry reads
// the padded cotangent buffer (g_r, g_g, g_b, g_wacc, dmax) at its
// (2f+1)^2 offsets and writes its 7 gradients (d_px, d_py, d_dn,
// d_sigma2, d_r, d_g, d_b) once, with the 50/50 credit where dn == dmax.
//
// Table layout: [B, S, 7, H, W] with H = W = res + 2f (channels px py dn
// sigma2 r g b; the interior holds the entries, the border is zero).
//
// What bounds them on an H100: bytes.  K4 at res 224, R = 52, S = 6 reads
// a 454 MB table and writes 52 MB, with ~40 flops per entry visit; K5
// reads the same table and a 54 MB cotangent buffer and writes a 438 MB
// gradient table.  Design: one thread per output element (K4: render x
// pixel; K5: render x slot x pixel), neighbouring threads on neighbouring
// pixels so every table read is coalesced; the (2f+1)^2 re-reads of an
// entry by neighbouring pixels come from L1/L2.  Staging a halo tile in
// shared memory is left for a later redesign.
//
// Rounding: every add, multiply and divide is a round-to-nearest
// intrinsic, so nvcc contracts nothing into FMAs, and the order is the
// Pallas kernel's (K4: slot-outer, offsets inner in raster order from -f
// to f; K5: offsets in raster order), which the plain twins in
// genpc_tpu_torch/render/splat_kernel.py follow.  exp is expf (not
// __expf), as torch's exp on the card.  No atomics: every output is
// written by one thread, so the results repeat bitwise.  Entries and
// offsets whose mask is false add +-0 in the twins and are skipped here,
// which leaves the sums unchanged.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCh = 7;

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
splat_fwd_kernel(const float* __restrict__ table, float* __restrict__ acc,
                 float* __restrict__ wacc, float* __restrict__ dmax_out,
                 int S, int res, int f, float gamma) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int npix = res * res;
  if (q >= npix) return;
  const int H = res + 2 * f;
  const size_t plane = (size_t)H * H;
  const int iqy = q / res, iqx = q - iqy * res;
  const float qx = (float)iqx, qy = (float)iqy;
  const float ff = (float)f, last = (float)(res - 1);
  const float* tb = table + (size_t)b * S * kCh * plane;

  // phase 0: dmax (max is exact in any order)
  float dmax = -1.0f;
  for (int s = 0; s < S; ++s) {
    const float* ts = tb + (size_t)s * kCh * plane;
    for (int oy = -f; oy <= f; ++oy) {
      for (int ox = -f; ox <= f; ++ox) {
        const size_t at = (size_t)(iqy + f - oy) * H + (iqx + f - ox);
        if (!(ts[3 * plane + at] > 0.0f)) continue;
        const float ixf = floorf(ts[at]);
        const float iyf = floorf(ts[plane + at]);
        const bool center_in = ixf >= 0.0f && ixf <= last && iyf >= 0.0f &&
                               iyf <= last;
        const bool win = fabsf(sub(qx, ixf)) <= ff && fabsf(sub(qy, iyf)) <= ff;
        if (center_in && win) dmax = fmaxf(dmax, ts[2 * plane + at]);
      }
    }
  }

  // phase 1: weighted sums, slot-outer, offsets inner (the Pallas order)
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aw = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float* ts = tb + (size_t)s * kCh * plane;
    for (int oy = -f; oy <= f; ++oy) {
      for (int ox = -f; ox <= f; ++ox) {
        const size_t at = (size_t)(iqy + f - oy) * H + (iqx + f - ox);
        const float s2 = ts[3 * plane + at];
        if (!(s2 > 0.0f)) continue;
        const float px = ts[at];
        const float py = ts[plane + at];
        const float ixf = floorf(px);
        const float iyf = floorf(py);
        const bool win = fabsf(sub(qx, ixf)) <= ff && fabsf(sub(qy, iyf)) <= ff;
        if (!win) continue;
        const float dx = sub(px, qx), dy = sub(py, qy);
        const float d2 = add(mul(dx, dx), mul(dy, dy));
        const float w_s = expf(dvd(-d2, fmaxf(mul(2.0f, s2), 1e-12f)));
        if (!(w_s > 1e-4f)) continue;
        const float expo = fminf(dvd(sub(ts[2 * plane + at], dmax), gamma),
                                 0.0f);
        const float w = mul(w_s, expf(expo));
        ar = add(ar, mul(w, ts[4 * plane + at]));
        ag = add(ag, mul(w, ts[5 * plane + at]));
        ab = add(ab, mul(w, ts[6 * plane + at]));
        aw = add(aw, w);
      }
    }
  }
  float* ob = acc + (size_t)b * 3 * npix;
  ob[q] = ar;
  ob[npix + q] = ag;
  ob[2 * npix + q] = ab;
  wacc[(size_t)b * npix + q] = aw;
  dmax_out[(size_t)b * npix + q] = dmax;
}

__global__ void __launch_bounds__(kThreads)
splat_bwd_kernel(const float* __restrict__ table, const float* __restrict__ cot,
                 float* __restrict__ out, int S, int res, int f, float gamma) {
  const int bs = blockIdx.y;            // render * S + slot
  const int b = bs / S;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int npix = res * res;
  if (q >= npix) return;
  const int H = res + 2 * f;
  const size_t plane = (size_t)H * H;
  const int iqy = q / res, iqx = q - iqy * res;
  const float qx = (float)iqx, qy = (float)iqy;
  const float ff = (float)f, last = (float)(res - 1);
  const float* te = table + (size_t)bs * kCh * plane;
  const size_t at = (size_t)(iqy + f) * H + (iqx + f);
  float* o = out + (size_t)bs * kCh * npix + q;

  float d_px = 0.0f, d_py = 0.0f, d_dn = 0.0f, d_s2 = 0.0f;
  float d_r = 0.0f, d_g = 0.0f, d_b = 0.0f;
  const float s2 = te[3 * plane + at];
  if (s2 > 0.0f) {
    const float px = te[at];
    const float py = te[plane + at];
    const float dn = te[2 * plane + at];
    const float cr = te[4 * plane + at];
    const float cg = te[5 * plane + at];
    const float cb = te[6 * plane + at];
    const float ixf = floorf(px);
    const float iyf = floorf(py);
    const float s2c = fmaxf(mul(2.0f, s2), 1e-12f);
    const float* cb_ = cot + (size_t)b * 5 * plane;
    for (int oy = -f; oy <= f; ++oy) {
      for (int ox = -f; ox <= f; ++ox) {
        const float qx2 = add(qx, (float)ox);
        const float qy2 = add(qy, (float)oy);
        const bool inb = qx2 >= 0.0f && qx2 <= last && qy2 >= 0.0f &&
                         qy2 <= last;
        const bool win = fabsf(sub(qx2, ixf)) <= ff &&
                         fabsf(sub(qy2, iyf)) <= ff;
        if (!(inb && win)) continue;
        const float dx = sub(px, qx2), dy = sub(py, qy2);
        const float d2 = add(mul(dx, dx), mul(dy, dy));
        const float w_s = expf(dvd(-d2, s2c));
        if (!(w_s > 1e-4f)) continue;
        const size_t ca = (size_t)(iqy + f + oy) * H + (iqx + f + ox);
        const float gr = cb_[ca];
        const float gg = cb_[plane + ca];
        const float gb = cb_[2 * plane + ca];
        const float gwa = cb_[3 * plane + ca];
        const float dmax = cb_[4 * plane + ca];
        const float expo_raw = dvd(sub(dn, dmax), gamma);
        const float e = expf(fminf(expo_raw, 0.0f));
        const float w = mul(w_s, e);
        const float gw = add(add(add(mul(gr, cr), mul(gg, cg)), mul(gb, cb)),
                             gwa);
        const float dw_s = mul(gw, e);
        const float dd2 = mul(mul(dw_s, w_s), dvd(-1.0f, s2c));
        d_px = add(d_px, mul(mul(dd2, 2.0f), dx));
        d_py = add(d_py, mul(mul(dd2, 2.0f), dy));
        const float tie_w = expo_raw < 0.0f ? 1.0f
                            : (expo_raw == 0.0f ? 0.5f : 0.0f);
        d_dn = add(d_dn, dvd(mul(mul(mul(tie_w, gw), w_s), e), gamma));
        d_s2 = add(d_s2, mul(mul(mul(dw_s, w_s), dvd(d2, mul(s2c, s2c))),
                             2.0f));
        d_r = add(d_r, mul(w, gr));
        d_g = add(d_g, mul(w, gg));
        d_b = add(d_b, mul(w, gb));
      }
    }
  }
  o[0] = d_px;
  o[(size_t)npix] = d_py;
  o[2 * (size_t)npix] = d_dn;
  o[3 * (size_t)npix] = d_s2;
  o[4 * (size_t)npix] = d_r;
  o[5 * (size_t)npix] = d_g;
  o[6 * (size_t)npix] = d_b;
}

}  // namespace

// table [B,S,7,res+2f,res+2f] -> acc [B,3,res,res], wacc, dmax [B,res,res]
extern "C" int genpc_splat_fwd(const float* table, float* acc, float* wacc,
                               float* dmax, int B, int S, int res, int f,
                               float gamma, void* stream) {
  if (B == 0 || res == 0) return 0;
  dim3 grid((res * res + kThreads - 1) / kThreads, B);
  splat_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, acc, wacc, dmax, S, res, f, gamma);
  return (int)cudaGetLastError();
}

// table [B,S,7,res+2f,res+2f], cot [B,5,res+2f,res+2f] -> out [B,S,7,res,res]
extern "C" int genpc_splat_bwd(const float* table, const float* cot,
                               float* out, int B, int S, int res, int f,
                               float gamma, void* stream) {
  if (B == 0 || S == 0 || res == 0) return 0;
  dim3 grid((res * res + kThreads - 1) / kThreads, B * S);
  splat_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, cot, out, S, res, f, gamma);
  return (int)cudaGetLastError();
}
