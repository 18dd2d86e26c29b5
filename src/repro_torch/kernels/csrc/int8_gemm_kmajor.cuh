// Shared K-major int8 x int8 -> int32 tensor-core GEMM main loop (sm_90a,
// mma.sync), written for the photonic matmul's K-major entry and shared
// with both GEMM phases of the fused FFN.
//
// One block of 4 warps computes a 64 x 64 output tile of C = A (M, K) .
// B^T, with A (M, K) and Bt (N, K) both row-major int8 codes: the tensor
// cores take int8 operands K-major only (mma.sync and wgmma alike, and
// Hopper has no 8-bit ldmatrix.trans), so the weight comes as its K-major
// copy (core/backend.py::QuantizedWeight.wt), made once with the cache
// entry, never per call. BK = 64 and BN = 64 keep the photonic tile rule:
// whole 32-wide wavelength chunks and 64-arm groups.
//
// A and Bt tiles move through a 4-stage cp.async ring of 16-byte chunks,
// so the loads of step k + 3 are in flight under the MMAs of step k; ragged
// rows and the K tail are zero-filled by the copy's src-size operand (K must
// be a multiple of 16, A and Bt 16-byte aligned: the wrappers check both).
// Each 64-byte tile row keeps its four chunks at c ^ ((row >> 1) & 3), so
// the 8 rows an ldmatrix reads fall in 8 different bank groups. Fragments
// come by ldmatrix (x4: two m-tiles of A, two n-tiles of B a k32 step) into
// mma.sync m16n8k32 s8 with int32 accumulators held in registers over the
// whole walk (the TPU kernels' VMEM scratch). 32 KB of static shared memory
// and 128 threads a block.
//
// The epilogue is a functor over the warp's accumulator pairs: for each of
// the thread's 4 column pairs (n, n + 1), in turn, epi.column(n) once (its
// per-column operands, e.g. scales and biases), then
// epi(m, n, column, acc(m, n), acc(m, n + 1)) for each of the pair's 4 rows
// m < M. n < N holds for every pair a thread is given; n + 1 may reach N.
#pragma once

#include "int8_gemm.cuh"   // mma_s8, dequant, the photonic tile rule

namespace repro {
namespace km {

constexpr int BM = 64, BN = 64, BK = 64;   // BM == BN: one tile shape for both
constexpr int kStages = 4;
constexpr int kThreads = 128;              // 4 warps, 2 x 2 over the tile
constexpr int kTileBytes = BM * BK;
static_assert(BM == BN, "the loader fills the a and bt tiles in one walk");
static_assert(BK % kWavelengths == 0, "BK must be a multiple of 32");
static_assert(BN % kArms == 0, "BN must be a multiple of 64");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes, reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// byte offset of 16-byte chunk c (0..3) of row r in a [rows][64] int8 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

// Output tile (blockIdx.y, blockIdx.x) of a (M, K) . bt (N, K)^T, handed
// to epi pair by pair (see the note above).
template <class Epi>
__device__ __forceinline__ void gemm_s8_tile(const int8_t* __restrict__ a,
                                             const int8_t* __restrict__ bt,
                                             int M, int K, int N, Epi& epi) {
  __shared__ __align__(128) int8_t smem[kStages][2][kTileBytes];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma groupID / thread in group
  const int wm = warp >> 1, wn = warp & 1;     // warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  // K step kt of the a and bt tiles into stage st: 256 chunks each
  auto load = [&](int kt, int st) {
    const uint32_t sa = smem_addr(smem[st][0]), sb = smem_addr(smem[st][1]);
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += kThreads) {
      const int r = i >> 2, c = i & 3;
      const int kc = kt * BK + c * 16;
      const bool ina = m0 + r < M && kc < K, inb = n0 + r < N && kc < K;
      cp_async16(sa + swz(r, c), a + (ina ? (size_t)(m0 + r) * K + kc : 0),
                 ina ? 16 : 0);
      cp_async16(sb + swz(r, c), bt + (inb ? (size_t)(n0 + r) * K + kc : 0),
                 inb ? 16 : 0);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();              // step kt has landed
    __syncthreads();                           // and step kt - 1 is consumed
    if (kt + kStages - 1 < KT) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

    const int st = kt % kStages;
    const uint32_t sa = smem_addr(smem[st][0]), sb = smem_addr(smem[st][1]);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)              // rows 0-15 x chunks 2ks, 2ks+1
        ldmatrix_x4(af[i], sa + swz(wm * 32 + i * 16 + (lane & 15),
                                    2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)           // n-tiles 2jp and 2jp + 1
        ldmatrix_x4(bf[jp], sb + swz(wn * 32 + jp * 16 + (lane & 7) +
                                         ((lane >> 4) << 3),
                                     2 * ks + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bj[2] = {bf[j >> 1][(j & 1) * 2],
                                  bf[j >> 1][(j & 1) * 2 + 1]};
          mma_s8(acc[i][j], af[i], bj);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + t * 2;
    if (n >= N) continue;
    const auto col = epi.column(n);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm * 32 + i * 16 + g + hf * 8;
        if (m < M) epi(m, n, col, acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
      }
  }
}

// Store the pair (y0, y1) at row-major (m, n), (m, n + 1) of a (M, N) f32
// output: one 8-byte store when N is even, else each element that exists.
__device__ __forceinline__ void store_pair(float* __restrict__ out, int m,
                                           int n, int N, float y0, float y1) {
  float* o = out + (size_t)m * N + n;
  if ((N & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
  } else {
    o[0] = y0;
    if (n + 1 < N) o[1] = y1;
  }
}

// The dequant epilogue (f32(acc) * s) * sw[n] into a (M, N) f32 output.
struct DequantEpi {
  const float* sw;
  float* out;
  float s;
  int N;
  __device__ __forceinline__ float2 column(int n) const {
    return make_float2(__ldg(sw + n), n + 1 < N ? __ldg(sw + n + 1) : 0.f);
  }
  __device__ __forceinline__ void operator()(int m, int n, float2 sc, int a0,
                                             int a1) const {
    store_pair(out, m, n, N, dequant(a0, s, sc.x), dequant(a1, s, sc.y));
  }
};

}  // namespace km
}  // namespace repro
