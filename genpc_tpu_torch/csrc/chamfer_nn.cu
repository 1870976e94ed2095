// One-directional nearest neighbour: for each point of x, the minimum
// squared distance into y and its argmin.
//
// Replaces the Pallas kernel genpc_tpu/ops/chamfer.py::_nn_kernel (row
// tiles x streamed column tiles with a running min/argmin, distance by
// the |x|^2+|y|^2-2x.y expansion on the MXU, then an exact recompute of
// the chosen pair in _nn).
//
// What bounds it on an H100: instruction issue.  Every (x, y) pair costs
// 8 fp32 operations (3 sub, 3 mul, 2 add; no FMA, for exactness), and a
// call holds up to ~7e10 pairs (the symmetry sweep) against a few MB of
// inputs.  One warp instruction issues per cycle on each of an SM's four
// schedulers, so what sets the pace is the instructions a pair costs:
// the old design (one x point a thread) paid 3 scalar shared loads, the
// 8 operations, a compare and two selects, ~14 a pair.
//
// Design:
//  * R x rows a thread (R = 2 or 4, ops/chamfer.nn_plan), rows tid + r *
//    blockDim.x of the block's R * blockDim.x, in registers; y streams
//    through shared memory as float4 tiles (xyz_tiles.cuh), one 16-byte
//    broadcast load serving R pairs.
//  * Groups of kGroup = 8 columns: the R x 8 distances are computed with
//    no branch between them (independent chains, so the schedulers always
//    have work), then one fminf tree a row and one compare with the
//    running best.  Only when the group's least distance is below it
//    (rare once the scan is under way) does the thread look for the
//    group's first index holding it.  That is ~9.4 instructions a pair
//    (8 + 7/8 min + the compare and branch a group) instead of ~11.
//  * Tiles double-buffered: the next tile's loads are in flight in
//    registers while the block scans this one, one barrier a tile.  The
//    wrapper could instead pad y to [By, M, 4] and copy with cp.async,
//    but that is one more launch and one more copy of y per call, and the
//    pose loop, which calls K1 400 times a pass, is bound by launches.
//  * The grid fitted to the shape: blocks over (batch, M split, row tile)
//    in one linear grid.x (no grid.y batch limit).  When nn_plan splits M
//    (launches too small to fill the 132 SMs with enough warps: the pose
//    loss's 52 x 512 rows, a one-cloud dedup, the metric), each split
//    writes its partial (min, argmin) to scratch the wrapper allocates,
//    and nn_merge_kernel takes them in split order with a strict '<': the
//    total order (d, then the lower j), so the result is bit-equal
//    whatever the split.
//
// Exactness: the direct form (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics, so nvcc does not contract it into FMAs: bitwise the plain
// torch version's distances.  A group updates the best only on a strict
// '<', and then takes its first index holding the minimum, so the first
// index wins ties, as argmin does (d is never -0, and fminf drops a NaN as
// '<' does).  A short last tile is padded with +inf points (xyz_tiles.cuh).
// No atomics.
//
// Batching: x is [B, N, 3]; y is [By, M, 3] and x batch b reads y batch
// y_index[b] (or b when y_index is null), so the symmetry sweep, ICP and
// the pose loss reuse one y per object instead of a copy per problem.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "xyz_tiles.cuh"

namespace {

using xyz_tiles::kGroup;
using xyz_tiles::kMaxThreads;

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
          const int* __restrict__ y_index, float* __restrict__ dist,
          int* __restrict__ idx, int B, int N, int M, int tiles, int splits,
          int chunk) {
  extern __shared__ float4 sy[];  // two tiles of 2 * blockDim.x points
  const int nt = blockDim.x;
  const int tp = xyz_tiles::tile_points(nt);
  const int tile = blockIdx.x % tiles;
  const int s = (blockIdx.x / tiles) % splits;
  const int b = blockIdx.x / tiles / splits;
  const int yb = y_index ? y_index[b] : b;
  const float* xb = x + (size_t)b * N * 3;
  const int c0 = s * chunk;
  const int len = min(M, c0 + chunk) - c0;
  const float* ys = y + ((size_t)yb * M + c0) * 3;
  const int row0 = tile * nt * R + threadIdx.x;

  float px[R], py[R], pz[R], best[R];
  int bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r * nt, N - 1);
    px[r] = xb[3 * (size_t)i];
    py[r] = xb[3 * (size_t)i + 1];
    pz[r] = xb[3 * (size_t)i + 2];
    best[r] = INFINITY;
    bj[r] = c0;
  }

  float v[6];
  xyz_tiles::fetch(ys, min(tp, len), v);
  xyz_tiles::store(sy, v);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < len; t0 += tp, buf ^= 1) {
    const int cnt = min(tp, len - t0);
    const bool more = t0 + tp < len;
    if (more) xyz_tiles::fetch(ys + 3 * (size_t)(t0 + tp),
                               min(tp, len - t0 - tp), v);
    const float4* cur = sy + buf * tp;
    const int base = c0 + t0;
    for (int j0 = 0; j0 < cnt; j0 += kGroup) {
      float d[R][kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 q = cur[j0 + g];
#pragma unroll
        for (int r = 0; r < R; ++r)
          d[r][g] = xyz_tiles::sq_dist(px[r], py[r], pz[r], q);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float mn = xyz_tiles::group_min<kGroup>(d[r]);
        if (mn < best[r]) {  // rare once the scan is under way
          int first = kGroup - 1;
#pragma unroll
          for (int g = kGroup - 2; g >= 0; --g)
            if (d[r][g] == mn) first = g;
          best[r] = mn;
          bj[r] = base + j0 + first;
        }
      }
    }
    if (more) xyz_tiles::store(sy + (buf ^ 1) * tp, v);
    __syncthreads();
  }
  // with splits > 1, dist and idx are the [splits, B, N] partials
  float* dout = dist + ((size_t)s * B + b) * N;
  int* iout = idx + ((size_t)s * B + b) * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * nt;
    if (i < N) {
      dout[i] = best[r];
      iout[i] = bj[r];
    }
  }
}

// The partials of the M splits, in split order (ascending j): strict '<'
// keeps the earlier split on equal distances, i.e. the lower index.
__global__ void nn_merge_kernel(const float* __restrict__ dpart,
                                const int* __restrict__ ipart,
                                float* __restrict__ dist,
                                int* __restrict__ idx, long long bn,
                                int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bn) return;
  float best = dpart[i];
  int bj = ipart[i];
  for (int s = 1; s < splits; ++s) {
    const float d = dpart[s * bn + i];
    if (d < best) {
      best = d;
      bj = ipart[s * bn + i];
    }
  }
  dist[i] = best;
  idx[i] = bj;
}

}  // namespace

// rows, threads, splits and chunk come from ops/chamfer.nn_plan; dpart and
// ipart ([splits, B, N]) are read only when splits > 1.
extern "C" int genpc_nn(const float* x, const float* y, const int* y_index,
                        float* dist, int* idx, float* dpart, int* ipart,
                        int B, int N, int M, int rows, int threads,
                        int splits, int chunk, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      splits < 1 || chunk < 1 || (long long)splits * chunk < M ||
      (splits > 1 && (dpart == nullptr || ipart == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + threads * rows - 1) / (threads * rows);
  const long long blocks = (long long)B * splits * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 2 * threads * sizeof(float4);
  cudaStream_t st = (cudaStream_t)stream;
  float* d = splits > 1 ? dpart : dist;
  int* ix = splits > 1 ? ipart : idx;
  switch (rows) {
    case 2:
      nn_kernel<2><<<(int)blocks, threads, smem, st>>>(
          x, y, y_index, d, ix, B, N, M, tiles, splits, chunk);
      break;
    case 4:
      nn_kernel<4><<<(int)blocks, threads, smem, st>>>(
          x, y, y_index, d, ix, B, N, M, tiles, splits, chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long bn = (long long)B * N;
  nn_merge_kernel<<<(int)((bn + 255) / 256), 256, 0, st>>>(dpart, ipart,
                                                         dist, idx, bn,
                                                         splits);
  return (int)cudaGetLastError();
}

extern "C" const char* genpc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
