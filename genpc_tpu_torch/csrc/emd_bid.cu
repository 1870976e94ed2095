// Auction-EMD bid phase: for every source row, the best value
// v = (3 - sqrt_rn(max(d2, 0))) - price over all targets, its first-index
// argmax, and the second-best value with only the argmax column excluded.
//
// Replaces the Pallas kernel genpc_tpu/ops/emd_kernel.py::_bid_kernel
// (one grid cell per 256 source rows, 2048-column chunks with a running
// top-2 merge kept in VMEM).
//
// What bounds it on an H100: instruction issue and, on the rare path,
// latency.  The metric calls it 50 times at B = 13, n = m = 16,384 (1.7e11
// pair values a pass) against ~3 MB of inputs.  Taken literally, every
// pair costs the distance (8 fp32 ops), a correctly rounded square root
// (MUFU rsqrt, a Newton fix-up and a slow-path test) and two
// subtractions, ~20 instructions, plus a float4 shared-memory load when a
// thread owns one row (the old design).
//
// Design:
//  * A conservative square-root filter.  A pair changes the running top
//    two only if v > second (v <= second leaves all three outputs
//    bit-identical: v > best is then false, and max(second, v) is second;
//    v is never -0, since 3 - s >= +0 and x - x rounds to +0, so a tie
//    v == second cannot flip a zero's sign).  Before the root, each row
//    tests d2 < reach, where reach is rebuilt from `second` and the least
//    price of the current tile whenever either changes:
//        w = RD(second + pmin), q = RU(3 - w),
//        reach = RU(RU(q * q) * (1 + 2^-21))      (q > 0; else 0: no pair
//                                                  can beat `second`)
//    Argument, for a column j with price p >= pmin: v = RN(a - p) with
//    a = RN(3 - s), s = RN(sqrt(d2)).  Round-to-nearest is monotone and
//    fixes floats, so RN(z) > f for a float f implies z > f.  Hence
//    v > second  =>  a - p > second  =>  a > second + pmin >= w
//    =>  3 - s > w  =>  s < q  =>  sqrt(d2) < q  =>  d2 < q^2 <= reach.
//    Each step rounds outward (the RD/RU intrinsics), so the bound holds
//    exactly; the factor 1 + 2^-21 widens it by a further ~4 ulps, slack
//    that admits a few more pairs to the exact path and costs nothing
//    measurable.  While second is -inf, reach is +inf and no finite pair
//    is skipped.  A skipped NaN pair would not have changed the outputs
//    either.  Pairs that pass take the exact formula above and the update
//    v > best ? (second = best, best = v, bid = j) : second = max(second,
//    v), so the outputs are bitwise those of the unfiltered kernel, and
//    the common path loses the square root and both subtractions.
//  * Groups of G columns (G = 4): the R x G squared distances with
//    no branch between them, then per row one fminf tree against reach;
//    only a row whose group holds a pair under reach walks the group pair
//    by pair.  A row lets few of its pairs through, but a warp holds 32
//    unrelated rows, so many of its row-group steps still enter the walk
//    (most of them early in the scan, while `second` is still low), and
//    that walk (root, branches, a dependent chain) is latency-bound: few
//    registers (R = 2, G = 4: 64) and so more warps an SM pay best
//    (ops/emd_kernel.bid_plan).
//  * R source rows a thread (R = 2), the targets and prices as
//    float4 tiles (x, y, z, price) double-buffered through registers as
//    in K1 (xyz_tiles.cuh); one warp `redux` per tile gives each warp's
//    least price, a barrier later the block's.
//  * Rows in the caller's order: the auction's sources are the same in
//    all 50 calls, so ops/emd.py sorts them once along a Morton curve and
//    passes that permutation; a warp then holds 32 neighbouring rows,
//    whose candidate columns are nearly the same few, and its walks are
//    shared instead of one for every row that has a candidate.  Each row
//    is computed alone, so the order cannot change a bit.
//  * The grid is one linear grid.x over (batch, row tile), sized by
//    bid_plan so that the metric's 13 x 16,384 rows fill the 132 SMs.
//
// The distance is the direct form (dx*dx + dy*dy) + dz*dz with
// round-to-nearest intrinsics (the Pallas kernel's form); the plain twin
// ops/emd_kernel.bid_plain_direct computes the same function in the same
// fp32 order and is bitwise equal.  A short last tile is padded with +inf
// points (xyz_tiles.cuh), whose +inf distance never passes the filter and
// would give a value of -inf, which changes nothing.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "xyz_tiles.cuh"

namespace {

using xyz_tiles::kMaxThreads;

constexpr float kWiden = 1.0f + 0x1p-21f;

// d2 < reach(second, pmin) for every pair of the tile whose value could
// exceed `second` (see the argument above)
__device__ __forceinline__ float reach(float second, float pmin) {
  const float q = __fsub_ru(3.f, __fadd_rd(second, pmin));
  if (q > 0.f) return __fmul_ru(__fmul_ru(q, q), kWiden);
  return q <= 0.f ? 0.f : INFINITY;  // q NaN: skip nothing
}

// floats as unsigned keys of the same order, for the warp min `redux`
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// this thread's share of the tile's prices (2 a thread), and the least
__device__ __forceinline__ unsigned fetch_prices(const float* __restrict__ p,
                                                 int cnt, float (&pv)[2]) {
  unsigned key = 0xffffffffu;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = threadIdx.x + q * blockDim.x;
    pv[q] = k < cnt ? p[k] : 0.f;
    if (k < cnt) key = min(key, order_key(pv[q]));
  }
  return key;
}

__device__ __forceinline__ void store_prices(float4* tile, unsigned* wmin,
                                             const float (&pv)[2],
                                             unsigned key) {
  float* f = reinterpret_cast<float*>(tile);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    f[(threadIdx.x + q * blockDim.x) * 4 + 3] = pv[q];
  key = __reduce_min_sync(0xffffffffu, key);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = key;
}

template <int R, int G>
__global__ void __launch_bounds__(kMaxThreads)
bid_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
           const float* __restrict__ price, const int* __restrict__ order,
           int* __restrict__ bid, float* __restrict__ best,
           float* __restrict__ better, int n, int m, int tiles) {
  // two tiles of 2 * blockDim.x targets, then each tile's warp minima
  extern __shared__ float4 smem[];
  const int nt = blockDim.x;
  const int nw = nt / 32;
  const int tp = xyz_tiles::tile_points(nt);
  unsigned* wmin = reinterpret_cast<unsigned*>(smem + 2 * tp);
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const float* xb = x1 + (size_t)b * n * 3;
  const float* yb = x2 + (size_t)b * m * 3;
  const float* pb = price + (size_t)b * m;
  const int row0 = tile * nt * R + threadIdx.x;

  float px[R], py[R], pz[R], bv[R], sv[R], thr[R];
  int bj[R], row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = min(row0 + r * nt, n - 1);
    const int i = order ? order[(size_t)b * n + k] : k;
    row[r] = i;
    px[r] = xb[3 * (size_t)i];
    py[r] = xb[3 * (size_t)i + 1];
    pz[r] = xb[3 * (size_t)i + 2];
    bv[r] = -INFINITY;
    sv[r] = -INFINITY;
    bj[r] = 0;
  }

  float v[6], pv[2];
  xyz_tiles::fetch(yb, min(tp, m), v);
  unsigned key = fetch_prices(pb, min(tp, m), pv);
  xyz_tiles::store(smem, v);
  store_prices(smem, wmin, pv, key);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < m; t0 += tp, buf ^= 1) {
    const int cnt = min(tp, m - t0);
    const bool more = t0 + tp < m;
    unsigned k = wmin[buf * nw];
    for (int w = 1; w < nw; ++w) k = min(k, wmin[buf * nw + w]);
    const float pmin = from_key(k);
#pragma unroll
    for (int r = 0; r < R; ++r) thr[r] = reach(sv[r], pmin);
    if (more) {
      const int next = min(tp, m - t0 - tp);
      xyz_tiles::fetch(yb + 3 * (size_t)(t0 + tp), next, v);
      key = fetch_prices(pb + t0 + tp, next, pv);
    }
    const float4* cur = smem + buf * tp;
    for (int j0 = 0; j0 < cnt; j0 += G) {
      float d2[R][G], pw[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 q = cur[j0 + g];
        pw[g] = q.w;
#pragma unroll
        for (int r = 0; r < R; ++r)
          d2[r][g] = xyz_tiles::sq_dist(px[r], py[r], pz[r], q);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!(xyz_tiles::group_min(d2[r]) < thr[r])) continue;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!(d2[r][g] < thr[r])) continue;
          const float val = __fsub_rn(
              __fsub_rn(3.f, __fsqrt_rn(fmaxf(d2[r][g], 0.f))), pw[g]);
          if (val > bv[r]) {
            sv[r] = bv[r];
            bv[r] = val;
            bj[r] = t0 + j0 + g;
          } else {
            sv[r] = fmaxf(sv[r], val);
          }
          thr[r] = reach(sv[r], pmin);
        }
      }
    }
    if (more) {
      xyz_tiles::store(smem + (buf ^ 1) * tp, v);
      store_prices(smem + (buf ^ 1) * tp, wmin + (buf ^ 1) * nw, pv, key);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r * nt < n) {
      const size_t i = (size_t)b * n + row[r];
      bid[i] = bj[r];
      best[i] = bv[r];
      better[i] = sv[r];
    }
  }
}

}  // namespace

// threads comes from ops/emd_kernel.bid_plan, and rows and group must be
// the one shape the kernel is built for (BID_ROWS, BID_GROUP there); order
// (nullable, [B, n]) is a permutation of each batch's rows: thread slot k
// takes row order[k]
extern "C" int genpc_emd_bid(const float* x1, const float* x2,
                             const float* price, const int* order,
                             int* bid, float* best,
                             float* better, int B, int n, int m, int rows,
                             int group, int threads, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (m < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + threads * rows - 1) / (threads * rows);
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 2 * threads * sizeof(float4) +
                      2 * (threads / 32) * sizeof(unsigned);
  cudaStream_t st = (cudaStream_t)stream;
  if (rows != 2 || group != 4) return (int)cudaErrorInvalidValue;
  bid_kernel<2, 4><<<(int)blocks, threads, smem, st>>>(
      x1, x2, price, order, bid, best, better, n, m, tiles);
  return (int)cudaGetLastError();
}
