// Double-buffered point tiles in shared memory, shared by K1
// (chamfer_nn.cu) and K3 (emd_bid.cu).
//
// A block streams the points of y (x, y, z fp32, packed) through two
// shared tiles of 2 * blockDim.x points each, stored as float4 so that one
// 16-byte broadcast load serves a thread's every row.  While the block
// scans one tile, each thread holds its share of the next in registers
// (6 floats: the tile's 6 * blockDim.x floats, read coalesced in global
// order), then writes it to the other buffer as float4; one
// __syncthreads() a tile orders the two.  A straight cp.async or TMA copy
// cannot turn packed xyz into float4, so the tile goes through registers;
// the loads are issued before the scan and consumed after it, so their
// latency hides behind the scan.
//
// A scan reads a tile in groups of kGroup points.  The slots past the
// last point of a short tile hold (+inf, +inf, +inf): its squared
// distance to any finite x is +inf (NaN for an infinite x), which never
// wins a strict '<' nor changes a min that has a finite candidate.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace xyz_tiles {

constexpr int kMaxThreads = 256;
constexpr int kGroup = 8;  // points a scan step reads at most (divides
                           // every tile)

//: points a tile holds, for a block of nt threads
__device__ __forceinline__ int tile_points(int nt) { return 2 * nt; }

//: this thread's share of the tile of cnt points at src (packed xyz),
//: +inf past the last point
__device__ __forceinline__ void fetch(const float* __restrict__ src, int cnt,
                                      float (&v)[6]) {
  const int nt = blockDim.x;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int k = threadIdx.x + q * nt;
    v[q] = k < 3 * cnt ? src[k] : INFINITY;
  }
}

//: write this thread's share into the tile's float4 slots (x, y, z)
__device__ __forceinline__ void store(float4* tile, const float (&v)[6]) {
  float* f = reinterpret_cast<float*>(tile);
  const int nt = blockDim.x;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int k = threadIdx.x + q * nt;
    f[(k / 3) * 4 + k % 3] = v[q];
  }
}

//: (dx*dx + dy*dy) + dz*dz, each operation rounded to nearest (no FMA)
__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float4 q) {
  const float dx = __fsub_rn(px, q.x);
  const float dy = __fsub_rn(py, q.y);
  const float dz = __fsub_rn(pz, q.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

//: the least of a group's G values (a tree of fminf: a NaN loses to any
//: number)
template <int G>
__device__ __forceinline__ float group_min(const float (&d)[G]) {
  float m[G / 2];
#pragma unroll
  for (int g = 0; g < G / 2; ++g) m[g] = fminf(d[2 * g], d[2 * g + 1]);
#pragma unroll
  for (int w = G / 4; w >= 1; w /= 2)
#pragma unroll
    for (int g = 0; g < w; ++g) m[g] = fminf(m[g], m[g + w]);
  return m[0];
}

}  // namespace xyz_tiles
