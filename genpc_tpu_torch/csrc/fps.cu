// Exact farthest-point sampling, the whole k-step loop per object.
//
// Replaces the Pallas kernel genpc_tpu/ops/fps_kernel.py::_kernel, which
// keeps an object's points and its min-distance table in VMEM and runs
// all k sequential steps on-chip.
//
// What bounds it on an H100: per step every point is read and its
// min-distance read and written (20 bytes a point), k times in sequence,
// with a block-wide argmax between steps.  An object's points (2 MB at
// 165k) and table (0.66 MB) overflow one SM's 227 KB of shared memory, so
// this first design is one block of 1024 threads per object with points
// and table in global memory: the 13 objects' ~35 MB stay L2-resident,
// and each step is one streaming pass plus a shuffle-and-shared-memory
// argmax.  Only B blocks run, so B = 13 leaves most of the 132 SMs idle
// and a lone object (the fusion FPS) uses one SM; spreading an object
// over a thread-block cluster (distributed shared memory) is the next
// step.
//
// Exactness: the distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics (no FMA contraction), min-distance starts at +inf, the start
// index is given, and the argmax keeps the lowest index among equal
// maxima (jnp.argmax / torch.argmax order), so the selected sequence
// equals the plain loop's.  k may exceed N: every further pick is then
// index 0 (all distances are 0), as in the plain loop.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, float* __restrict__ min_d,
           int* __restrict__ out, int N, int k, int start) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_sel;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = pts + (size_t)b * N * 3;
  float* md = min_d + (size_t)b * N;
  int* o = out + (size_t)b * k;

  // each thread owns the points j = tid + t*kThreads for the whole run
  for (int j = threadIdx.x; j < N; j += kThreads) md[j] = INFINITY;
  if (threadIdx.x == 0) o[0] = start;
  int last = start;

  for (int step = 1; step < k; ++step) {
    const float sx = p[3 * (size_t)last];
    const float sy = p[3 * (size_t)last + 1];
    const float sz = p[3 * (size_t)last + 2];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const float dx = __fsub_rn(p[3 * (size_t)j], sx);
      const float dy = __fsub_rn(p[3 * (size_t)j + 1], sy);
      const float dz = __fsub_rn(p[3 * (size_t)j + 2], sz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[j], d);
      md[j] = m;
      if (m > bv) {  // j rises within a thread: strict keeps the lowest
        bv = m;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                   __shfl_down_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                     __shfl_down_sync(0xffffffffu, bi, off));
      if (lane == 0) {
        s_sel = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    last = s_sel;
  }
}

}  // namespace

extern "C" int genpc_fps(const float* pts, float* min_d, int* out, int B,
                         int N, int k, int start, void* stream) {
  if (B == 0 || k == 0) return 0;
  fps_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(pts, min_d, out, N, k,
                                                       start);
  return (int)cudaGetLastError();
}
