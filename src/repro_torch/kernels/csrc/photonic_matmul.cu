// Photonic w8a8 matmul for Hopper: int8 (M, K) . int8 (K, N) -> int32 on the
// tensor cores, then the dequant epilogue (f32(acc) * sx) * sw[n] -> f32
// (M, N). The int32 accumulate is exact (bitwise against any order), and the
// epilogue is the reference's two separately rounded products.
//
// Replaces: src/repro/kernels/photonic_matmul.py::photonic_matmul_kernel.
//
// What bounds it on an H100: at the serving shapes (M = 200..1568 token
// rows, K = 768, N = 768) a call moves ~1.4-6.6 MB and does 0.2-1.9 GOP of
// int8 work, so the int8 tensor-core roof (1,979 TOP/s) and the HBM roof
// (3.35 TB/s) are both 1-2 microseconds away; the latency of the K walk
// (12 steps of 64 at K = 768) and the launch bound it in practice.
//
// K-major entry (photonic_matmul_s8_kmajor_kernel), every K a multiple of
// 16: the tensor cores take int8 operands K-major only (mma.sync and wgmma
// alike, and Hopper has no 8-bit ldmatrix.trans), so it reads the weight
// from the quantize-once cache's K-major copy wt (N, K), made once when the
// cache entry is made (core/backend.py::QuantizedWeight.wt), never per
// call. A block of 4 warps owns a 64 x 64 output tile (BK = 64 and BN = 64
// keep the photonic tile rule: whole 32-wide wavelength chunks and 64-arm
// groups); at (788, 768, 768) its 156 blocks are all resident at once on
// the 132 SMs (32 KB of shared memory and 128 threads a block). x and wt
// tiles move through a 4-stage cp.async ring of 16-byte chunks, so the
// loads of step k + 3 are in flight under the MMAs of step k; ragged rows
// and the K tail are zero-filled by the copy's src-size operand. Each
// 64-byte tile row keeps its four chunks at c ^ ((row >> 1) & 3), so the 8
// rows an ldmatrix reads fall in 8 different bank groups. Fragments come
// by ldmatrix (x4: two m-tiles of A, two n-tiles of B a k32 step) into
// mma.sync m16n8k32 s8 with int32 accumulators held in registers over the
// whole walk (the TPU kernel's VMEM scratch); the dequant is fused into the
// store. wgmma (descriptor-built shared-memory layouts) is not used: at
// these shapes the K walk's latency, not the MMA rate, bounds the kernel.
//
// N-major entry (photonic_matmul_s8_kernel), K not a multiple of 16
// (MGNet's 196 x 196 score head): the first design, kept unchanged on the
// shared main loop of int8_gemm.cuh. It reads the row-major (K, N) codes
// with synchronous loads and transposes each tile into shared memory.
#include "int8_gemm.cuh"

namespace {

__global__ void __launch_bounds__(repro::kGemmThreads)
photonic_matmul_s8_kernel(const int8_t* __restrict__ xq,
                          const int8_t* __restrict__ wq,
                          const float* __restrict__ sx,
                          const float* __restrict__ sw,
                          float* __restrict__ out, int M, int K, int N) {
  const float s = *sx;
  repro::gemm_s8_tile(repro::LoadS8{xq, M, K}, wq, M, K, N,
                      [&](int m, int n, int acc) {
                        out[(size_t)m * N + n] = repro::dequant(acc, s, sw[n]);
                      });
}

namespace km {

constexpr int BM = 64, BN = 64, BK = 64;   // BM == BN: one tile shape for both
constexpr int kStages = 4;
constexpr int kThreads = 128;              // 4 warps, 2 x 2 over the tile
constexpr int kTileBytes = BM * BK;
static_assert(BK % repro::kWavelengths == 0, "BK must be a multiple of 32");
static_assert(BN % repro::kArms == 0, "BN must be a multiple of 64");

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

__global__ void __launch_bounds__(kThreads)
photonic_matmul_s8_kmajor_kernel(const int8_t* __restrict__ xq,
                                 const int8_t* __restrict__ wt,
                                 const float* __restrict__ sx,
                                 const float* __restrict__ sw,
                                 float* __restrict__ out, int M, int K,
                                 int N) {
  __shared__ __align__(128) int8_t smem[kStages][2][kTileBytes];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma groupID / thread in group
  const int wm = warp >> 1, wn = warp & 1;     // warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  // K step kt of the x and wt tiles into stage st: 256 chunks each
  auto load = [&](int kt, int st) {
    const uint32_t a = smem_addr(smem[st][0]), b = smem_addr(smem[st][1]);
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += kThreads) {
      const int r = i >> 2, c = i & 3;
      const int kc = kt * BK + c * 16;
      const bool ina = m0 + r < M && kc < K, inb = n0 + r < N && kc < K;
      cp_async16(a + swz(r, c), xq + (ina ? (size_t)(m0 + r) * K + kc : 0),
                 ina ? 16 : 0);
      cp_async16(b + swz(r, c), wt + (inb ? (size_t)(n0 + r) * K + kc : 0),
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
    const uint32_t a = smem_addr(smem[st][0]), b = smem_addr(smem[st][1]);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)              // rows 0-15 x chunks 2ks, 2ks+1
        ldmatrix_x4(af[i], a + swz(wm * 32 + i * 16 + (lane & 15),
                                   2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)           // n-tiles 2jp and 2jp + 1
        ldmatrix_x4(bf[jp], b + swz(wn * 32 + jp * 16 + (lane & 7) +
                                        ((lane >> 4) << 3),
                                    2 * ks + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bj[2] = {bf[j >> 1][(j & 1) * 2],
                                  bf[j >> 1][(j & 1) * 2 + 1]};
          repro::mma_s8(acc[i][j], af[i], bj);
        }
    }
  }
  cp_async_wait<0>();

  const float s = *sx;
  const bool pairs = (N & 1) == 0;             // 8-byte aligned (n, n + 1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + t * 2;
    const float sw0 = n < N ? sw[n] : 0.f, sw1 = n + 1 < N ? sw[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm * 32 + i * 16 + g + hf * 8;
        if (m >= M) continue;
        const float y0 = repro::dequant(acc[i][j][2 * hf], s, sw0);
        const float y1 = repro::dequant(acc[i][j][2 * hf + 1], s, sw1);
        float* o = out + (size_t)m * N + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          if (n < N) o[0] = y0;
          if (n + 1 < N) o[1] = y1;
        }
      }
  }
}

}  // namespace km

}  // namespace

// N-major entry: wq (K, N) row-major, any M, K, N
extern "C" int photonic_matmul_s8(const void* xq, const void* wq,
                                  const void* sx, const void* sw, void* out,
                                  int M, int K, int N, void* stream) {
  const dim3 grid((N + repro::BN - 1) / repro::BN,
                  (M + repro::BM - 1) / repro::BM);
  photonic_matmul_s8_kernel<<<grid, repro::kGemmThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// K-major entry: wt (N, K) row-major, K a multiple of 16, xq and wt 16-byte
// aligned (the wrapper checks both)
extern "C" int photonic_matmul_s8_kmajor(const void* xq, const void* wt,
                                         const void* sx, const void* sw,
                                         void* out, int M, int K, int N,
                                         void* stream) {
  const dim3 grid((N + km::BN - 1) / km::BN, (M + km::BM - 1) / km::BM);
  km::photonic_matmul_s8_kmajor_kernel<<<grid, km::kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wt),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
