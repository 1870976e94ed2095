// Auction-EMD bid phase: for every source row, the best value
// v = 3 - ||x - y|| - price over all targets, its first-index argmax, and
// the second-best value with only the argmax column excluded.
//
// Replaces the Pallas kernel genpc_tpu/ops/emd_kernel.py::_bid_kernel
// (one grid cell per 256 source rows, 2048-column chunks with a running
// top-2 merge kept in VMEM).
//
// What bounds it on an H100: arithmetic, with a square root per pair:
// the metric calls it 50 times at B = 13, n = m = 16,384, i.e. 1.7e11
// pair values, against ~3 MB of inputs.  Design: one thread per source
// row; targets and prices stream through shared memory as float4 tiles
// that the block reads as broadcasts; the running top-2 lives in
// registers and no [rows, m] value matrix ever exists.  Top-2 rule: on
// v > best, second = best and best = v, bid = j; otherwise second =
// max(second, v).  A later column tying the best therefore sets
// second == best, which is the "exclude only the argmax column" rule of
// the reference.  The loop runs to m with a bound check (no 1e30 price
// padding).  The distance is the direct form (dx*dx + dy*dy) + dz*dz with
// round-to-nearest intrinsics; the plain version uses the reference's
// |x|^2+|y|^2-2x.y expansion, so near-equal targets may order differently
// (the contract is >= 99.5% identical bids, values within 2e-4).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // targets per shared tile: 32 KB

__global__ void __launch_bounds__(kThreads)
bid_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
           const float* __restrict__ price, int* __restrict__ bid,
           float* __restrict__ best, float* __restrict__ better, int n,
           int m) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* xb = x1 + (size_t)b * n * 3;
  const float* yb = x2 + (size_t)b * m * 3;
  const float* pb = price + (size_t)b * m;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = xb[3 * (size_t)i];
    py = xb[3 * (size_t)i + 1];
    pz = xb[3 * (size_t)i + 2];
  }
  float bv = -INFINITY, sv = -INFINITY;
  int bj = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const size_t j = (size_t)(t0 + k);
      tile[k] = make_float4(yb[3 * j], yb[3 * j + 1], yb[3 * j + 2], pb[j]);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 t = tile[j];
      const float dx = __fsub_rn(px, t.x);
      const float dy = __fsub_rn(py, t.y);
      const float dz = __fsub_rn(pz, t.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float v = __fsub_rn(__fsub_rn(3.f, __fsqrt_rn(fmaxf(d2, 0.f))),
                                t.w);
      if (v > bv) {
        sv = bv;
        bv = v;
        bj = t0 + j;
      } else {
        sv = fmaxf(sv, v);
      }
    }
  }
  if (i < n) {
    bid[(size_t)b * n + i] = bj;
    best[(size_t)b * n + i] = bv;
    better[(size_t)b * n + i] = sv;
  }
}

}  // namespace

extern "C" int genpc_emd_bid(const float* x1, const float* x2,
                             const float* price, int* bid, float* best,
                             float* better, int B, int n, int m,
                             void* stream) {
  if (B == 0 || n == 0) return 0;
  dim3 grid((n + kThreads - 1) / kThreads, B);
  bid_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x1, x2, price, bid, best, better, n, m);
  return (int)cudaGetLastError();
}
