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
// assemble_bwd_points): the transpose of K4 as a gather, for the entries
// the caller keeps.  Each point reads its own table entry, then the
// cotangents (g_r, g_g, g_b, g_wacc) and dmax at the (2f+1)^2 offsets of
// the pixel the entry is stored at, and writes its 7 gradients (d_px,
// d_py, d_dn, d_sigma2, d_r, d_g, d_b) once, with the 50/50 credit where
// dn == dmax; a dropped point writes zeros.
//
// Table layout: [B, S, 7, H, W] with H = W = res + 2f (channels px py dn
// sigma2 r g b; the interior holds the entries, the border is zero).  The
// renders may lie any number of floats apart (rstride): _build_table's
// table is a view of a [B, S*7*H*W + 1] buffer whose last element takes
// the writes of dropped points, and the kernels read that view in place.
// The [S, 7, H, W] block of a render is contiguous.
//
// What bounds them on an H100.  At most 0.7 % of the table's entries are
// present (R = 52 renders of <= 2,048 points into 6 x 228^2 slots at res
// 224).  K4 must read the sigma2 plane of every slot (it marks presence),
// the other channels of the present entries, and write 5 output planes:
// about 120 MB, so bytes, ~0.04 ms.  K5 must read the cotangents around
// the present entries and the entries themselves, and write 7 floats a
// point: about 20-50 MB, so bytes again.
//
// K4's design: one block a tile of 32 x 8 pixels of one render, one warp
// a tile row.  The block copies the sigma2 planes of its tile and f-wide
// halo into shared memory with cp.async (4-byte copies, so any row pitch
// works: TMA would need (res + 2f) % 4 == 0, which res 50 and f = 1 or 3
// break), then turns each halo row of each slot into a 64-bit presence
// word with two warp ballots (32 + 2f <= 64 columns).  A tile whose words
// are all zero writes its outputs and returns; a warp skips the slots
// with no entry in its 2f + 1 window rows.  Otherwise each thread walks,
// per slot and window row, the set bits of its (2f+1)-bit window from the
// highest (the kernel order: ascending ox is descending entry column),
// and only those entries touch device memory for px, py, dn and rgb; they
// are few and were just fetched by neighbouring pixels, so they come from
// L1/L2.  Both phases walk the same words.
//
// K5's design: one thread a (render, point).  It finds its entry from
// slot_orig (rank = slot_orig / npix, pixel = slot_orig % npix, the
// clamped centre the entry is stored at), reads its 7 channels, and reads
// the unpadded cotangents only at offsets that pass the in-image and
// window tests.  No dense gradient table exists.  The points come in the
// caller's order, which is spatially scattered (random or FPS samples),
// so a warp's 32 windows would fall on 32 different cache lines; the
// threads take the points in the table's build order instead (sorted by
// pixel, `order`), so that a warp's windows overlap and share them.
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

constexpr int kThreads = 256;     // K5 block
constexpr int kTileW = 32;        // K4 tile: one warp a row of 32 pixels,
constexpr int kTileH = 8;         // 8 rows (256 threads)
constexpr int kCh = 7;

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Shared memory of a K4 block: S * hh presence words, then the sigma2
// planes [S, hh, hw] (hh = kTileH + 2f, hw = kTileW + 2f).
__global__ void __launch_bounds__(kTileW * kTileH, 4)
splat_fwd_kernel(const float* __restrict__ table, long long rstride,
                 float* __restrict__ acc, float* __restrict__ wacc,
                 float* __restrict__ dmax_out, int S, int res, int f,
                 float gamma, int tiles_x) {
  extern __shared__ unsigned long long smem[];
  const int hw = kTileW + 2 * f, hh = kTileH + 2 * f;
  unsigned long long* mask = smem;
  float* s2s = reinterpret_cast<float*>(mask + S * hh);
  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const int H = res + 2 * f;
  const size_t plane = (size_t)H * H;
  const float* tb = table + (size_t)b * rstride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = kTileW * kTileH / 32;
  const int rows = S * hh;

  // stage the sigma2 planes of the tile and its halo; cells past the
  // table's edge (only ever read for pixels past the image's) are zero
  for (int row = warp; row < rows; row += warps) {
    const int s = row / hh, gy = y0 + row - s * hh;
    const float* src = tb + (size_t)s * kCh * plane + 3 * plane +
                       (size_t)gy * H + x0;
    float* dst = s2s + row * hw;
    for (int c = lane; c < hw; c += 32) {
      if (gy < H && x0 + c < H) cp_async4(dst + c, src + c);
      else dst[c] = 0.0f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // presence words: bit k of mask[s * hh + r] = halo column k present
  int any = 0;
  for (int row = warp; row < rows; row += warps) {
    const float* v = s2s + row * hw;
    const unsigned lo = __ballot_sync(0xffffffffu, lane < hw && v[lane] > 0.0f);
    const unsigned hi = __ballot_sync(0xffffffffu,
                                      lane + 32 < hw && v[lane + 32] > 0.0f);
    const unsigned long long m = ((unsigned long long)hi << 32) | lo;
    if (lane == 0) mask[row] = m;
    any |= m != 0ull;
  }
  const bool live = __syncthreads_or(any);

  // the slots with an entry in this warp's window rows (bit s; S <= 32):
  // the others are skipped by the whole warp
  const int lx = lane, ly = warp;
  unsigned long long rows_or = 0ull;
  if (lane < S)
    for (int r = ly; r <= ly + 2 * f; ++r) rows_or |= mask[lane * hh + r];
  const unsigned slots_live = __ballot_sync(0xffffffffu, rows_or != 0ull);

  const int iqx = x0 + lx, iqy = y0 + ly;
  if (iqx >= res || iqy >= res) return;
  const int npix = res * res;
  const int q = iqy * res + iqx;
  float* ob = acc + (size_t)b * 3 * npix;
  if (!live) {
    ob[q] = 0.0f;
    ob[npix + q] = 0.0f;
    ob[2 * npix + q] = 0.0f;
    wacc[(size_t)b * npix + q] = 0.0f;
    dmax_out[(size_t)b * npix + q] = -1.0f;
    return;
  }
  const float qx = (float)iqx, qy = (float)iqy;
  const float ff = (float)f, last = (float)(res - 1);
  const unsigned long long win_bits = (2ull << (2 * f)) - 1ull;

  // phase 0: dmax.  Offset (oy, ox) reads the entry at padded position
  // (iqy + f - oy, iqx + f - ox): halo row ly + f - oy, halo column
  // lx + k with k = f - ox, so ascending ox is descending k.
  float dmax = -1.0f;
  for (int s = 0; s < S; ++s) {
    if (!(slots_live >> s & 1u)) continue;
    const float* ts = tb + (size_t)s * kCh * plane;
    for (int oy = -f; oy <= f; ++oy) {
      const int r = ly + f - oy;
      unsigned long long bits = (mask[s * hh + r] >> lx) & win_bits;
      while (bits) {
        const int k = 63 - __clzll(bits);
        bits ^= 1ull << k;
        const size_t at = (size_t)(y0 + r) * H + (x0 + lx + k);
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
    if (!(slots_live >> s & 1u)) continue;
    const float* ts = tb + (size_t)s * kCh * plane;
    for (int oy = -f; oy <= f; ++oy) {
      const int r = ly + f - oy;
      const float* s2r = s2s + (s * hh + r) * hw + lx;
      unsigned long long bits = (mask[s * hh + r] >> lx) & win_bits;
      while (bits) {
        const int k = 63 - __clzll(bits);
        bits ^= 1ull << k;
        const size_t at = (size_t)(y0 + r) * H + (x0 + lx + k);
        const float s2 = s2r[k];
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
  ob[q] = ar;
  ob[npix + q] = ag;
  ob[2 * npix + q] = ab;
  wacc[(size_t)b * npix + q] = aw;
  dmax_out[(size_t)b * npix + q] = dmax;
}

__global__ void __launch_bounds__(kThreads)
splat_bwd_points_kernel(const float* __restrict__ table, long long rstride,
                        const long long* __restrict__ slot_orig,
                        const long long* __restrict__ order,
                        const float* __restrict__ g_acc, long long ga_b,
                        long long ga_c, long long ga_y, long long ga_x,
                        const float* __restrict__ g_wacc,
                        const float* __restrict__ dmax_in,
                        float* __restrict__ out, int B, int N, int S,
                        int res, int f, float gamma) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * N) return;
  const int b = (int)(i / N);
  const int n = order ? (int)order[i] : (int)(i - (long long)b * N);
  if (n < 0 || n >= N) return;
  const int npix = res * res;
  const long long so = slot_orig[(size_t)b * N + n];

  float d_px = 0.0f, d_py = 0.0f, d_dn = 0.0f, d_s2 = 0.0f;
  float d_r = 0.0f, d_g = 0.0f, d_b = 0.0f;
  if (so >= 0 && so < (long long)S * npix) {
    const int rank = (int)(so / npix), pix = (int)(so - (long long)rank * npix);
    const int iqy = pix / res, iqx = pix - iqy * res;
    const int H = res + 2 * f;
    const size_t plane = (size_t)H * H;
    const float* te = table + (size_t)b * rstride + (size_t)rank * kCh * plane;
    const size_t at = (size_t)(iqy + f) * H + (iqx + f);
    const float s2 = te[3 * plane + at];
    if (s2 > 0.0f) {
      const float px = te[at];
      const float py = te[plane + at];
      const float dn = te[2 * plane + at];
      const float cr = te[4 * plane + at];
      const float cg = te[5 * plane + at];
      const float cb = te[6 * plane + at];
      const float qx = (float)iqx, qy = (float)iqy;
      const float ff = (float)f, last = (float)(res - 1);
      const float ixf = floorf(px);
      const float iyf = floorf(py);
      const float s2c = fmaxf(mul(2.0f, s2), 1e-12f);
      const float* ga = g_acc + (size_t)b * ga_b;
      const float* gwb = g_wacc + (size_t)b * npix;
      const float* dmb = dmax_in + (size_t)b * npix;
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
          const int y = iqy + oy, x = iqx + ox;
          const float* gq = ga + y * ga_y + x * ga_x;
          const float gr = gq[0];
          const float gg = gq[ga_c];
          const float gb = gq[2 * ga_c];
          const float gwa = gwb[y * res + x];
          const float dmax = dmb[y * res + x];
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
  }
  float* o = out + (size_t)b * kCh * N + n;
  o[0] = d_px;
  o[(size_t)N] = d_py;
  o[2 * (size_t)N] = d_dn;
  o[3 * (size_t)N] = d_s2;
  o[4 * (size_t)N] = d_r;
  o[5 * (size_t)N] = d_g;
  o[6 * (size_t)N] = d_b;
}

}  // namespace

// table [B,S,7,res+2f,res+2f] (renders rstride floats apart) -> acc
// [B,3,res,res], wacc, dmax [B,res,res]; grid (tiles, B) of 32 x 8
// threads with smem bytes of shared memory (splat_plan)
extern "C" int genpc_splat_fwd(const float* table, long long rstride,
                               float* acc, float* wacc, float* dmax, int B,
                               int S, int res, int f, float gamma,
                               int tiles_x, int tiles, int smem,
                               void* stream) {
  if (B == 0 || res == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        splat_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  splat_fwd_kernel<<<dim3(tiles, B), kTileW * kTileH, smem,
                     (cudaStream_t)stream>>>(table, rstride, acc, wacc, dmax,
                                             S, res, f, gamma, tiles_x);
  return (int)cudaGetLastError();
}

// table [B,S,7,res+2f,res+2f] (renders rstride floats apart), slot_orig
// [B,N] int64, order [B,N] int64 (thread j of render b serves point
// order[b, j]; null: point j), g_acc [B,3,res,res] at strides (ga_b,
// ga_c, ga_y, ga_x), g_wacc and dmax [B,res,res] contiguous -> out
// [B,7,N]
extern "C" int genpc_splat_bwd_points(
    const float* table, long long rstride, const long long* slot_orig,
    const long long* order, const float* g_acc, long long ga_b,
    long long ga_c, long long ga_y, long long ga_x, const float* g_wacc,
    const float* dmax, float* out, int B, int N, int S, int res, int f,
    float gamma, void* stream) {
  const long long total = (long long)B * N;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  splat_bwd_points_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, rstride, slot_orig, order, g_acc, ga_b, ga_c, ga_y, ga_x,
      g_wacc, dmax, out, B, N, S, res, f, gamma);
  return (int)cudaGetLastError();
}
