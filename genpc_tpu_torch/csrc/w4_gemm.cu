// K6: the weight-only int4 matmul of models/quant.QuantLinear, one launch
// a layer: y[M, N] = cast((x[M, K] @ codes[N, K]^T) * scale[N] + bias[N]).
//
// Replaces no Pallas kernel: the reference's weight-only matmul
// (genpc_tpu/models/quant.py, QuantDense) is XLA, an unpack, a convert and
// a dot with an fp32 result.  The port did the same in plain torch: two
// shifts and a stack to interleave the nibbles, a convert of the whole
// layer to the compute type, cuBLAS, then an fp32 addcmul and a cast.
// That wrote and read each layer's weight at 4-8x its packed bytes, plus
// an fp32 product, on every call.  Here the packed weight is read as it
// is stored ([N, K/2] int8, input 2i in the low nibble of byte i and 2i+1
// in the high one), turned into codes in registers, multiplied with fp32
// accumulation, and scaled, biased and cast in the epilogue: nothing but
// y is written to device memory.
//
// Two paths, chosen by the wrapper from what a call shows (its compute
// type), each with a C entry:
//
// genpc_w4_gemm, the tensor-core path (every bf16 layer).  Bound by
// operations: 2MNK flops over NK/2 weight bytes is 4M flops a byte, far
// above the ~295 an H100 needs to be compute-bound in bf16, for M >= 128.
// (On an H100 it is 1.06-4.9x faster than the CUDA-core path at 8-16
// rows of the FLUX and T5 shapes; at 1-4 rows that path is mostly faster,
// up to 2.6x, but no bf16 int4 layer of the port runs at so few rows.)
// It computes y^T = W . x^T, so that the weight is wgmma's A operand,
// taken from registers: a register of A's fragment holds two consecutive
// K values of one row as bf16x2, and one stored byte holds just those
// two codes, so a byte becomes a register with a byte permute, a lop3
// into the mantissa of a bf16 magic number (0x4300 | (c + 8), the value
// 128 + c + 8) and one bf16x2 subtraction of 136: codes -8..7 are exact
// in bf16.  A block holds 128 weight rows (two warpgroups of 64) against
// BM rows of x: 256 or 192, whichever's waves of blocks take less time,
// or 64 where both would leave the card half idle (quant.w4_row_tile).
// Each K-step of 64 has a stage in shared memory: x's tile (K-major,
// wgmma's B, in the 128-byte swizzle) lands by TMA, one thread asking
// and the stage's mbarrier counting the bytes; the block's 128 x 32
// packed bytes land by cp.async.  (x's tiles by cp.async instead cost a
// third of the kernel's time: 2,048 16-byte copies a block a K-step at
// BM = 256.)  The loads run stages - 2 K-steps ahead (the weight's one
// more), and a K-step's codes are made from shared memory while the
// previous one's wgmmas run, alternating between two register sets.  The epilogue
// applies the scale and bias in fp32, casts to bf16, stages the tile in
// shared memory and writes y in 16-byte rows.  Each output is one
// block's own sum, in a fixed order: no split-K, so a result repeats
// bitwise.
//
// genpc_w4_gemv, the CUDA-core path (every fp32 layer: the AdaLN
// modulations run at M = batch with fp32 activations, which the tensor
// cores cannot multiply in full fp32).  Bound by the packed weight's
// bytes at small M (N K / 2 bytes once).  A warp owns 4 weight
// rows and streams them in 16-byte loads across its lanes; x (1 or 4
// rows a block) sits in shared memory as fp32, one padding word every
// 32 so that the lanes' reads fall in distinct banks; every product is
// an fp32 FMA of an exact code and an exact fp32 x.  A warp's partial
// sums meet in a fixed shuffle tree: no reduction across blocks.
//
// Ragged edges: rows of x beyond M, columns beyond K and weight rows
// beyond N are masked (TMA fills zeros); K need only be even.  TMA needs
// x's rows 16-byte aligned: where K is not a multiple of 8 the wrapper
// copies x into rows of a padded pitch (ldx), whose pad TMA never reads.
// Where K is not a multiple of 32 (a row of packed bytes is then not
// 16-byte aligned) the weight's rows land by 4-byte cp.async of aligned
// windows (BM = 64 only): K-step kt's 32 bytes of a row begin `off` =
// (row start) % 4 bytes into its window, so a row's codes are its window
// shifted by off bytes, the last word's high bytes from the next K-step's
// window (a funnel shift); the loads run one K-step further ahead, and
// bytes beyond the row meet zeros of x.  The arithmetic is the same.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kThreads = 256;         // both paths: 8 warps a block
// tensor-core path
constexpr int kTileK = 64;            // K a stage: one 128-byte bf16 row

// A tensor-core block: 2 warpgroups, 128 weight rows, BM rows of x; its
// stages (each one K-step of x and of the packed weight) and the blocks an
// SM is to hold (registers: BM / 2 accumulators a thread).
constexpr int kTileN = 128;
constexpr int kPitch = kTileN + 8;    // epilogue tile row, bf16 elements
template <int BM> struct TileCfg {
  static constexpr int kStages = BM == 64 ? 6 : 4;
  static constexpr int kBlocksPerSM = BM == 64 ? 2 : 1;
  static constexpr int kXBytes = BM * kTileK * 2;
  static constexpr int kStageBytes = kXBytes + kTileN * kTileK / 2;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static_assert(BM * kPitch * 2 <= kStages * kStageBytes,
                "the epilogue's tile reuses the stages");
};
// CUDA-core path
constexpr int kRowsPerWarp = 4;
constexpr int kGemvRows = kRowsPerWarp * kThreads / 32;   // 32 a block
constexpr int kGemvFloats = 16384;    // x floats a block keeps (per chunk)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D tile of the tensor map at (c0 inner, c1 outer) -> shared memory,
// completing on the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused in this layout.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep registers an asynchronous wgmma reads or writes live, and their
// uses in place, up to this point
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x n] += A[64 x 16] (registers, bf16x2) * B[16 x n] (shared, K-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int BM>
__device__ __forceinline__ void wgmma_tile(float (&d)[BM / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  wgmma_m64n64k16(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_tile<192>(float (&d)[96],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  wgmma_m64n192k16(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_tile<256>(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  wgmma_m64n256k16(d, a, desc_b);
}

// Byte `sel`'s nibbles of `raw` -> bf16x2 (low half: the low nibble, the
// even K).  `sel` is the byte permute picking byte t of raw into byte 0
// and byte t of raw >> 4 (its high nibble) into byte 2.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t raw, uint32_t sel) {
  const uint32_t p = __byte_perm(raw, raw >> 4, sel);
  uint32_t v, out;
  // (p & 0x000F000F) ^ 0x43084308: 0x4300 | (nibble ^ 8) = 128 + code + 8
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(v)
      : "r"(p), "r"(0x000F000Fu), "r"(0x43084308u));
  // v * 1 - 136 = code, exactly
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

// Tensor-core path.  Thread roles: warpgroup wg (0, 1) owns weight rows
// n0 + 64 wg .. +63; within it warp w owns 16 rows, lane (g = lane / 4,
// t = lane % 4) the rows g and g + 8 of those 16 and, in each K-step of
// 16, the columns 2t, 2t+1 and 8+2t, 9+2t: bytes t and t + 4 of each
// 8-byte K-step of a packed row, byte t of every 4-byte word.
//
// A stage holds one K-step of 64: x's BM rows (BM x 128 bytes, swizzled)
// and the 128 weight rows' 32 packed bytes each.  K-step kt (its codes
// already made): wait for its stage, issue its 4 wgmmas, start the loads
// of x's K-step kt + stages - 2 into the stage kt - 2 used and of the
// weight's kt + stages - 1, wait for kt - 1's wgmmas, then make kt + 1's
// codes in the register set kt - 1 used.
template <int BM, bool kAligned>
__global__ void __launch_bounds__(kThreads, TileCfg<BM>::kBlocksPerSM)
    w4_gemm_kernel(const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K,
                   int vec_out, const __grid_constant__ CUtensorMap x_map) {
  using Cfg = TileCfg<BM>;
  constexpr int S = Cfg::kStages;
  static_assert(kAligned || S >= 4, "a ragged K-step reads two stages");
  // cp.async groups left pending when a K-step's codes are made: a
  // ragged row's codes read the next K-step's window too
  constexpr int kAhead = kAligned ? S - 3 : S - 4;
  constexpr int kXBytes = Cfg::kXBytes, kStageBytes = Cfg::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  // stages 1024-byte aligned (the swizzle's atom)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * BM;
  const int half_k = K / 2;                     // packed bytes a row
  const int ktiles = (K + kTileK - 1) / kTileK;
  // the weight's K-steps: a ragged row's last codes lie in the window
  // after its last K-step
  const int wtiles = kAligned ? ktiles : ktiles + 1;
  const int row = 64 * wg + 16 * warp + g;      // this thread's rows: +0, +8
  const uint32_t sel = t | (t << 4) | ((t + 4) << 8) | ((t + 4) << 12);
  // the bit shift of this thread's two rows within their windows
  uint32_t shift[2] = {0, 0};
  if (!kAligned)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      shift[h] = 8 * (((size_t)(n0 + row + 8 * h) * half_k) & 3);

  // x's K-steps land by TMA: one thread asks, the stage's barrier counts
  // the bytes
  __shared__ uint64_t full[S];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K-step kt of x -> stage kt % S, in the 128-byte swizzle
  auto load_x = [&](int kt) {
    if (tid == 0) {
      const uint32_t base = smem_u32(smem + (kt % S) * kStageBytes);
      mbar_expect_tx(&full[kt % S], kXBytes);
      tma_load_2d(base, &x_map, &full[kt % S], kt * kTileK, m0);
    }
  };
  // K-step kt of the packed weight -> stage kt % S: a 16-byte half of one
  // row's 32 bytes a thread; ragged, the same half of the row's 4-byte
  // aligned window (a word is read where it holds a byte of the row)
  auto load_w = [&](int kt) {
    const int r = tid / 2, c = tid % 2;
    const int n = n0 + r, b = kt * (kTileK / 2) + 16 * c;
    const uint32_t dst = smem_u32(smem + (kt % S) * kStageBytes + kXBytes +
                                  r * (kTileK / 2) + 16 * c);
    if (kAligned) {
      const uint8_t* src = w + (size_t)n * half_k + b;
      const bool ok = n < N && b < half_k;
      cp_async16(dst, ok ? src : w, ok);
    } else {
      const size_t start = (size_t)n * half_k;
      const size_t at = (start & ~size_t(3)) + b;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = n < N && at + 4 * i < start + half_k;
        cp_async4(dst + 4 * i, ok ? w + at + 4 * i : w, ok);
      }
    }
  };

  // K-step kt's codes: word q of a row's 32 bytes feeds K-step q / 2 of
  // 16, its byte t the columns 2t, 2t+1 (q even) or 8+2t, 9+2t (q odd)
  auto make_codes = [&](int kt, uint32_t (&a)[4][4]) {
    const uint8_t* ws = smem + (kt % S) * kStageBytes + kXBytes;
    uint32_t raw[2][9];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            ws + (row + 8 * h) * (kTileK / 2) + 16 * c);
        raw[h][4 * c + 0] = v.x;
        raw[h][4 * c + 1] = v.y;
        raw[h][4 * c + 2] = v.z;
        raw[h][4 * c + 3] = v.w;
      }
    if (!kAligned) {
      const uint8_t* next = smem + ((kt + 1) % S) * kStageBytes + kXBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        raw[h][8] = *reinterpret_cast<const uint32_t*>(
            next + (row + 8 * h) * (kTileK / 2));
#pragma unroll
        for (int q = 0; q < 8; ++q)
          raw[h][q] = __funnelshift_r(raw[h][q], raw[h][q + 1], shift[h]);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][0] = codes_bf16x2(raw[0][2 * s], sel);
      a[s][1] = codes_bf16x2(raw[1][2 * s], sel);
      a[s][2] = codes_bf16x2(raw[0][2 * s + 1], sel);
      a[s][3] = codes_bf16x2(raw[1][2 * s + 1], sel);
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4] = {}, a1[4][4] = {};

  // the loads run a K-step further ahead for the weight than for x: a
  // group holds x's K-step j and the weight's j + 1, so that the codes of
  // K-step kt + 1 are made while kt's wgmmas run
  auto step = [&](int kt, uint32_t (&a)[4][4], uint32_t (&prev)[4][4]) {
    cp_async_wait<kAhead>();
    mbar_wait(&full[kt % S], (kt / S) & 1);
    __syncthreads();
    const uint32_t base = smem_u32(smem + (kt % S) * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_tile<BM>(acc, a[s], desc_sw128(base + 32 * s));
    wgmma_commit();
    if (kt + S - 2 < ktiles) load_x(kt + S - 2);
    if (kt + S - 1 < wtiles) load_w(kt + S - 1);
    cp_async_commit();
    wgmma_wait<1>();
    fence_operands(prev);
    if (kt + 1 < ktiles) make_codes(kt + 1, prev);
  };

  load_w(0);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < S - 2; ++j) {
    if (j < ktiles) load_x(j);
    if (j + 1 < wtiles) load_w(j + 1);
    cp_async_commit();
  }
  cp_async_wait<kAhead + 1>();
  __syncthreads();
  make_codes(0, a0);
  int kt = 0;
  for (; kt + 1 < ktiles; kt += 2) {
    step(kt, a0, a1);
    step(kt + 1, a1, a0);
  }
  if (kt < ktiles) step(kt, a0, a1);
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(a0);
  fence_operands(a1);
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: fp32 scale and bias, bf16, through shared memory
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  float sc[2], bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + row + 8 * h;
    sc[h] = n < N ? scale[n] : 0.f;
    bi[h] = n < N && bias != nullptr ? bias[n] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      const int m = 8 * j + 2 * t + (e % 2);
      const float v = __fadd_rn(__fmul_rn(acc[4 * j + e], sc[h]), bi[h]);
      tile[m * kPitch + row + 8 * h] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * (kTileN / 8); i += kThreads) {
    const int r = i / (kTileN / 8), c = i % (kTileN / 8);
    const int m = m0 + r, n = n0 + 8 * c;
    if (m >= M || n >= N) continue;
    const __nv_bfloat16* src = tile + r * kPitch + 8 * c;
    __nv_bfloat16* dst = y + (size_t)m * N + n;
    if (vec_out && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// code of nibble j of a word already xor-ed with 0x88888888: the float
// 2^23 + code + 8, less 2^23 + 8 (exact)
__device__ __forceinline__ float nibble_code(uint32_t v, int j) {
  return __int_as_float(0x4B000000 | ((v >> (4 * j)) & 0xF)) - 8388616.0f;
}

// CUDA-core path.  Block: 8 warps, 32 weight rows, MT rows of x
// (m0 = blockIdx.y * MT); x streams through shared memory in chunks of kc K values, one padding word
// every 32; lane l reads the 16-byte pieces l, l + 32, ... of a row's
// chunk (32 codes each).
template <int MT>
__global__ void __launch_bounds__(kThreads)
    w4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int M, int N, int K, int kc, int vec_in) {
  extern __shared__ float xs[];
  const int pitch = kc + kc / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kGemvRows + warp * kRowsPerWarp;
  const int m0 = blockIdx.y * MT;
  const int half_k = K / 2;

  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    __syncthreads();
    for (int i = tid; i < MT * kc; i += kThreads) {
      const int m = i / kc, k = i % kc;
      xs[m * pitch + k + k / 32] = m0 + m < M && k < kn
                                       ? x[(size_t)(m0 + m) * K + k0 + k]
                                       : 0.f;
    }
    __syncthreads();
    for (int p = lane; p * 32 < kn; p += 32) {
      uint32_t wv[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int n = n0 + r;
        const size_t b0 = (size_t)n * half_k + k0 / 2 + p * 16;
        if (n < N && vec_in && p * 32 + 32 <= kn) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + b0));
          wv[r][0] = v.x; wv[r][1] = v.y; wv[r][2] = v.z; wv[r][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t v = 0;
            for (int b = 0; b < 4; ++b)
              if (n < N && p * 32 + 8 * q + 2 * b < kn)
                v |= (uint32_t)__ldg(w + b0 + 4 * q + b) << (8 * b);
            wv[r][q] = v;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[r][q] ^= 0x88888888u;
      }
      const float* xp = xs + 33 * p;     // k + k / 32 at k = 32 p
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          float xv[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) xv[m] = xp[m * pitch + 8 * q + j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float c = nibble_code(wv[r][q], j);
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(c, xv[m], acc[r][m]);
          }
        }
      }
    }
  }

  // a fixed butterfly: every lane ends with the same sums
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], o);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int n = n0 + r;
      if ((r * MT + m) % 32 != lane || n >= N || m0 + m >= M) continue;
      const float b = bias != nullptr ? bias[n] : 0.f;
      const float v = __fadd_rn(__fmul_rn(acc[r][m], scale[n]), b);
      y[(size_t)(m0 + m) * N + n] = v;
    }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the driver's cuTensorMapEncodeTiled, found through the runtime (no link
// against the driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int BM, bool kAligned>
cudaError_t run_gemm(const void* x, const void* w, const float* scale,
                     const float* bias, void* y, int M, int N, int K,
                     int ldx, int vec_out, cudaStream_t st) {
  using Cfg = TileCfg<BM>;
  // x as a 2-D tensor map for TMA (rows ldx apart): a box of 64 K by BM
  // rows in the 128-byte swizzle, zeros beyond M and K
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * 2};
  const cuuint32_t box[2] = {kTileK, BM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(x), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      w4_gemm_kernel<BM, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + BM - 1) / BM);
  w4_gemm_kernel<BM, kAligned><<<grid, kThreads, Cfg::kSmem, st>>>(
      static_cast<const uint8_t*>(w), scale, bias,
      static_cast<__nv_bfloat16*>(y), M, N, K, vec_out, map);
  return cudaGetLastError();
}

template <int MT>
cudaError_t run_gemv(const void* x, const void* w, const float* scale,
                     const float* bias, void* y, int M, int N, int K,
                     int vec_in, cudaStream_t st) {
  const int kc = std::min(kGemvFloats / MT, (K + 31) / 32 * 32);
  const int smem = MT * (kc + kc / 32) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      w4_gemv_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kGemvRows - 1) / kGemvRows, (M + MT - 1) / MT);
  w4_gemv_kernel<MT><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w), scale,
      bias, static_cast<float*>(y), M, N, K, kc, vec_in);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 in rows ldx apart (ldx >= K, a multiple of 8, x 16-byte
// aligned), w [N, K/2] int8 (packed codes, 4-byte aligned), scale [N]
// fp32, bias [N] fp32 or null, y [M, N] bf16; bm (256, 192 or 64) rows of
// x a block, 64 where the weight's rows are not 16-byte aligned.
extern "C" int genpc_w4_gemm(const void* x, const void* w, const float* scale,
                             const float* bias, void* y, int M, int N, int K,
                             int ldx, int bm, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 2 || K % 2 || ldx < K || ldx % 8 ||
      !aligned16(x) || reinterpret_cast<uintptr_t>(w) & 3)
    return (int)cudaErrorInvalidValue;
  // the weight's rows 16-byte aligned; y's for 16-byte stores
  const bool aligned = K % 32 == 0 && aligned16(w);
  const int vec_out = N % 8 == 0 && aligned16(y);
  cudaStream_t st = (cudaStream_t)stream;
  if (!aligned)
    return bm == 64 ? (int)run_gemm<64, false>(x, w, scale, bias, y, M, N,
                                               K, ldx, vec_out, st)
                    : (int)cudaErrorInvalidValue;
  switch (bm) {
    case 64:
      return (int)run_gemm<64, true>(x, w, scale, bias, y, M, N, K, ldx,
                                     vec_out, st);
    case 192:
      return (int)run_gemm<192, true>(x, w, scale, bias, y, M, N, K, ldx,
                                      vec_out, st);
    case 256:
      return (int)run_gemm<256, true>(x, w, scale, bias, y, M, N, K, ldx,
                                      vec_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same product on the CUDA cores in fp32: x [M, K] and y [M, N] fp32;
// mt (1 or 4) rows of x a block.
extern "C" int genpc_w4_gemv(const void* x, const void* w, const float* scale,
                             const float* bias, void* y, int M, int N, int K,
                             int mt, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 2 || K % 2) return (int)cudaErrorInvalidValue;
  const int vec_in = K % 32 == 0 && aligned16(w);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mt) {
    case 1: return (int)run_gemv<1>(x, w, scale, bias, y, M, N, K, vec_in,
                                    st);
    case 4: return (int)run_gemv<4>(x, w, scale, bias, y, M, N, K, vec_in,
                                    st);
    default: return (int)cudaErrorInvalidValue;
  }
}
