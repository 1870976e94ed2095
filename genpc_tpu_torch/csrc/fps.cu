// Exact farthest-point sampling, the whole k-pick loop of each object in
// one launch, each object spread over a thread-block cluster.
//
// Replaces the Pallas kernel genpc_tpu/ops/fps_kernel.py::_kernel, which
// keeps an object's points and its min-distance table in VMEM and runs
// all k sequential picks on-chip, reading nothing from HBM per pick.
//
// What bounds it on an H100: the serial chain of k-1 picks.  Every pick
// updates each point's min-distance (8 fp32 operations a point, 8N(k-1)
// in all: the bound) and needs the object-wide argmax before the next
// pick can start.  So a pick is one pass over each block's slice, then a
// reduction across the cluster whose latency (two block barriers, one
// cluster barrier, one distributed-shared-memory read, three levels of
// warp reductions) does not shrink with the slice: a small object on one
// block pays it too, k-1 times.  With the points on-chip, the pass costs
// shared-memory loads and fp32 instruction slots, not DRAM bytes.
//
// Memory placement.  An object needs 16 bytes a point: 12 of xyz, read
// every pick, and 4 of min-distance, read and written every pick.  One
// SM holds 227 KB of shared memory and 256 KB of registers, so one SM
// keeps at most ~19k points on-chip, and a fusion cloud (~229k points)
// or a metric cloud (163,840) needs 12-16 SMs.  So an object runs on a
// cluster of C blocks (grid B x C, cluster dimension C, one block an
// SM), block r owning the contiguous slice [r*S, (r+1)*S) with
// S = ceil(N / C):
//   - the slice's x, y, z live in shared memory as three float arrays
//     (a thread reads x[i], y[i], z[i] at i = tid + t*kThreads: no bank
//     conflicts);
//   - each thread owns the points i = tid + t*kThreads, t < PPT, for the
//     whole run, so their min-distances live in its registers (md[PPT]);
//   - at most kThreads * 32 = 16,384 points a block are on-chip
//     (192 KB of xyz, 32 registers of min-distance a thread).  The
//     wrapper picks the smallest power-of-two C <= 16 whose slice fits;
//     where even C = 16 leaves a slice longer than that, the rest of the
//     slice streams from global memory (L2) with its min-distance there,
//     as a single-block design would do for all of it.
// C above 8 is a non-portable cluster size: the launch sets
// cudaFuncAttributeNonPortableClusterSizeAllowed, and the wrapper asks
// cudaOccupancyMaxActiveClusters first and raises when no cluster fits.
//
// One pick: every thread updates its points and keeps its (value,
// index) maximum; the block reduces those with two warp redux
// instructions a level (the largest value's bits, then the lowest index
// carrying it) and shared memory; thread 0 writes the block's candidate
// (value, index, x, y, z) into its own shared-memory slot for this pick's
// parity; one cluster barrier; warp 0 of every block reads the C slots
// through distributed shared memory and merges them, so every block
// holds the same winner and its coordinates, with no global-memory round
// trip; block rank 0 writes the index.  The slots are double-buffered by
// pick parity: a block that runs ahead writes the other slot, and it
// cannot come back to this one before every block has passed the next
// barrier, which each reaches only after reading.  So one cluster
// barrier a pick suffices.
//
// Exactness: the distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics (no FMA contraction), min-distance starts at +inf, the start
// index is given, and every merge keeps the larger value and, among
// equal values, the lower index (jnp.argmax / torch.argmax order).  That
// merge is associative and commutative, so the sequence equals the plain
// loop's for every C.  k may exceed N: every further pick is then index 0
// (all distances are 0), as in the plain loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
constexpr unsigned kAll = 0xffffffffu;

// A candidate is (key, index): the key is the bit pattern of a
// min-distance, which orders as the float does since distances are >= +0;
// (0, kNone) stands for no point.
constexpr unsigned kNone = 0xffffffffu;

// One block's candidate for a pick, with the point's coordinates.
struct Pick {
  unsigned key;
  unsigned i;
  float x, y, z;
};

// The warp's largest key and the lowest index that carries it, in every
// lane (two redux instructions instead of a shuffle tree).
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& i) {
  const unsigned top = __reduce_max_sync(kAll, key);
  i = __reduce_min_sync(kAll, key == top ? i : kNone);
  key = top;
}

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float qx, float qy, float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ pts, float* __restrict__ min_d,
                   int* __restrict__ out, int N, int k, int start,
                   int slice) {
  constexpr int kCap = kThreads * PPT;
  extern __shared__ float s_xyz[];        // x[kCap], y[kCap], z[kCap]
  __shared__ unsigned s_key[kWarps];
  __shared__ unsigned s_idx[kWarps];
  __shared__ Pick s_slot[2];              // this block's candidate, by parity
  __shared__ Pick s_win;                  // the cluster's winner
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sx = s_xyz;
  float* sy = s_xyz + kCap;
  float* sz = s_xyz + 2 * kCap;
  const float* p = pts + (size_t)b * N * 3;
  float* md_g = min_d == nullptr ? nullptr : min_d + (size_t)b * N;
  int* o = out + (size_t)b * k;

  // this block's slice [lo, hi): [lo, tail) on-chip, [tail, hi) streamed
  const int lo = min(rank * slice, N);
  const int hi = min(lo + slice, N);
  const int tail = lo + min(hi - lo, kCap);
  for (int i = tid; i < tail - lo; i += kThreads) {
    sx[i] = p[3 * (size_t)(lo + i)];
    sy[i] = p[3 * (size_t)(lo + i) + 1];
    sz[i] = p[3 * (size_t)(lo + i) + 2];
  }
  for (int j = tail + tid; j < hi; j += kThreads) md_g[j] = INFINITY;
  float md[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) md[t] = INFINITY;
  if (rank == 0 && tid == 0) o[0] = start;
  float qx = p[3 * (size_t)start];
  float qy = p[3 * (size_t)start + 1];
  float qz = p[3 * (size_t)start + 2];
  __syncthreads();

  for (int step = 1; step < k; ++step) {
    // update this thread's points; indices rise within a thread, so a
    // strict '>' keeps the lowest index among equal maxima
    float bv = -1.0f;                     // below every distance
    unsigned bi = kNone;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const int i = tid + t * kThreads;
      if (lo + i < tail) {
        const float m = fminf(md[t], dist2(sx[i], sy[i], sz[i], qx, qy, qz));
        md[t] = m;
        if (m > bv) {
          bv = m;
          bi = lo + i;
        }
      }
    }
    for (int j = tail + tid; j < hi; j += kThreads) {
      const float m = fminf(md_g[j], dist2(p[3 * (size_t)j],
                                           p[3 * (size_t)j + 1],
                                           p[3 * (size_t)j + 2], qx, qy, qz));
      md_g[j] = m;
      if (m > bv) {
        bv = m;
        bi = j;
      }
    }

    // the block's candidate (a thread without points: bv = -1 -> key 0,
    // index kNone)
    unsigned key = __float_as_uint(fmaxf(bv, 0.0f));
    warp_argmax(key, bi);
    if (lane == 0) {
      s_key[warp] = key;
      s_idx[warp] = bi;
    }
    __syncthreads();
    const int par = step & 1;
    if (warp == 0) {
      key = lane < kWarps ? s_key[lane] : 0u;
      bi = lane < kWarps ? s_idx[lane] : kNone;
      warp_argmax(key, bi);
      if (lane == 0) {
        Pick c = {key, bi, 0.0f, 0.0f, 0.0f};
        if (bi < (unsigned)tail) {        // on-chip (bi >= lo by ownership)
          c.x = sx[bi - lo];
          c.y = sy[bi - lo];
          c.z = sz[bi - lo];
        } else if (bi < (unsigned)hi) {   // streamed
          c.x = p[3 * (size_t)bi];
          c.y = p[3 * (size_t)bi + 1];
          c.z = p[3 * (size_t)bi + 2];
        }                                 // else: an empty slice
        s_slot[par] = c;
      }
    }
    cluster.sync();

    // the cluster's winner: warp 0 merges the C candidates read through
    // distributed shared memory, then takes the winner's coordinates from
    // the lane that read it
    if (warp == 0) {
      Pick c = {0u, kNone, 0.0f, 0.0f, 0.0f};
      if (lane < C) c = *cluster.map_shared_rank(&s_slot[par], lane);
      unsigned top = c.key;
      unsigned i = c.i;
      warp_argmax(top, i);
      const int src = __ffs(__ballot_sync(kAll, c.i == i)) - 1;
      const float wx = __shfl_sync(kAll, c.x, src);
      const float wy = __shfl_sync(kAll, c.y, src);
      const float wz = __shfl_sync(kAll, c.z, src);
      if (lane == 0) {
        s_win = Pick{top, i, wx, wy, wz};
        if (rank == 0) o[step] = (int)i;
      }
    }
    __syncthreads();
    qx = s_win.x;
    qy = s_win.y;
    qz = s_win.z;
  }
  // no block may leave while another can still read its slots
  cluster.sync();
}

// One launch: B objects of N points, each on a cluster of C blocks.
struct Launch {
  const float* pts;
  float* min_d;
  int* out;
  int B, N, k, start, C, slice;
  cudaStream_t stream;
};

// Launch the PPT variant; with active != nullptr, report instead how
// many clusters of C blocks fit on the card at once.
template <int PPT>
cudaError_t run(const Launch& a, int* active) {
  const int smem = 3 * kThreads * PPT * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fps_cluster_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fps_cluster_kernel<PPT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return cudaOccupancyMaxActiveClusters(active, fps_cluster_kernel<PPT>,
                                          &cfg);
  return cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT>, a.pts, a.min_d,
                            a.out, a.N, a.k, a.start, a.slice);
}

cudaError_t dispatch(int ppt, const Launch& a, int* active) {
  if (a.C < 1 || a.C > kMaxCluster) return cudaErrorInvalidValue;
  switch (ppt) {                        // points a thread keeps on-chip
    case 1: return run<1>(a, active);
    case 2: return run<2>(a, active);
    case 4: return run<4>(a, active);
    case 8: return run<8>(a, active);
    case 16: return run<16>(a, active);
    case 32: return run<32>(a, active);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// How many clusters of C blocks of the PPT variant fit on the current
// device at once (0: none, the launch would fail).
extern "C" int genpc_fps_active_clusters(int C, int ppt, int* active) {
  *active = 0;
  const Launch a = {nullptr, nullptr, nullptr, 1, 0, 0, 0, C, 0, nullptr};
  cudaError_t e = dispatch(ppt, a, active);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// pts [B,N,3], out [B,k]; an object per cluster of C blocks, block r on
// points [r*slice, (r+1)*slice), kThreads*ppt of them on-chip and the
// rest of the slice streamed with its min-distance in min_d [B,N] (null
// when every slice fits on-chip).
extern "C" int genpc_fps(const float* pts, float* min_d, int* out, int B,
                         int N, int k, int start, int C, int slice, int ppt,
                         void* stream) {
  if (B == 0 || k == 0) return 0;
  if (slice < 1 || (long long)slice * C < N ||
      (min_d == nullptr && slice > kThreads * ppt))
    return (int)cudaErrorInvalidValue;
  const Launch a = {pts, min_d, out, B, N, k, start, C, slice,
                    (cudaStream_t)stream};
  cudaError_t e = dispatch(ppt, a, nullptr);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
