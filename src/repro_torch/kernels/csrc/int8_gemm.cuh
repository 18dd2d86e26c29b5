// Shared int8 x int8 -> int32 tensor-core GEMM main loop (sm_90a, mma.sync).
//
// One block computes a BM x BN output tile of C = A (M, K) . B (K, N) with
// A and B as int8 codes, walking K in BK-deep steps. B is row-major (K, N)
// in device memory (the quantize-once weight cache's layout); the loader
// transposes each tile into shared memory as Bs[n][k] so that the "col"
// operand fragment of mma.m16n8k32 is one 32-bit word per register.
// Ragged M, K and N are zero-filled by the loaders and masked in the
// epilogue: nothing is padded in device memory.
//
// The A loader and the epilogue are template functors, so the N-major
// entries (the first designs) of the photonic matmul (int8 A, dequant
// epilogue) and of both phases of the fused FFN (int8 A / GELU epilogue;
// f32 hidden A requantized on load / dequant epilogue) share this one main
// loop. The K-major entries run on int8_gemm_kmajor.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Tile configuration. The photonic tile rule of the reference kernel holds:
// BK is a whole number of 32-wide wavelength chunks and BN a whole number of
// 64-arm groups.
constexpr int kWavelengths = 32;
constexpr int kArms = 64;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kGemmThreads = 128;        // 4 warps, 2 x 2 over the tile
constexpr int kSmemStride = BK + 16;     // bytes; 20-word rows: no bank conflicts
static_assert(BK % kWavelengths == 0, "BK must be a multiple of 32");
static_assert(BN % kArms == 0, "BN must be a multiple of 64");

// Four consecutive int8 codes of row r, columns [c, c + 4), of a row-major
// (rows, cols) matrix with leading dimension ld; zero outside the matrix.
__device__ __forceinline__ uint32_t load4_s8(const int8_t* p, int r, int c,
                                             int rows, int cols, int ld) {
  if (r >= rows || c >= cols) return 0u;
  const int8_t* q = p + (size_t)r * ld + c;
  if (c + 4 <= cols && (reinterpret_cast<uintptr_t>(q) & 3u) == 0)
    return *reinterpret_cast<const uint32_t*>(q);
  uint32_t v = 0u;
  for (int i = 0; i < 4; ++i)
    if (c + i < cols) v |= (uint32_t)(uint8_t)q[i] << (8 * i);
  return v;
}

// A operand already quantized to int8 codes (M, K) row-major.
struct LoadS8 {
  const int8_t* a;
  int M, K;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    return load4_s8(a, r, c, M, K, K);
  }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C tile (blockIdx.y, blockIdx.x) of A (M, K) . B (K, N); calls
// epi(m, n, acc) once for every in-range output element.
template <class LoadA, class Epi>
__device__ __forceinline__ void gemm_s8_tile(const LoadA& load_a,
                                             const int8_t* __restrict__ b,
                                             int M, int K, int N,
                                             const Epi& epi) {
  __shared__ __align__(16) int8_t As[BM][kSmemStride];
  __shared__ __align__(16) int8_t Bs[BN][kSmemStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma groupID / thread in group
  const int wm = warp >> 1, wn = warp & 1;     // warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM rows x BK bytes = 1024 words, 8 per thread.
    for (int w = tid; w < BM * BK / 4; w += kGemmThreads) {
      const int r = w / (BK / 4), c = (w % (BK / 4)) * 4;
      *reinterpret_cast<uint32_t*>(&As[r][c]) = load_a(m0 + r, k0 + c);
    }
    // B tile: 4 consecutive n of one k row per word, scattered to Bs[n][k].
    for (int w = tid; w < BK * BN / 4; w += kGemmThreads) {
      const int kr = w / (BN / 4), c = (w % (BN / 4)) * 4;
      const uint32_t v = load4_s8(b, k0 + kr, n0 + c, K, N, N);
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[c + i][kr] = (int8_t)((v >> (8 * i)) & 0xffu);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + t * 4]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + t * 4]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + t * 4]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + t * 4]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + t * 2 + (e & 1);
        if (m < M && n < N) epi(m, n, acc[i][j][e]);
      }
}

// The reference dequant epilogue: (f32(acc) * sx) * sw[n], two separately
// rounded products (no FMA contraction), exactly as the reference kernel's
// `acc.astype(f32) * sx * sw` evaluates. f32(acc) rounds to nearest even
// once |acc| > 2^24, the same conversion the reference performs.
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

}  // namespace repro
