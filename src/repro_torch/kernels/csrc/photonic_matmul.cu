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
// 16: the shared K-major main loop of int8_gemm_kmajor.cuh (a 4-stage
// cp.async ring with an XOR swizzle, ldmatrix, mma.sync m16n8k32 s8; its
// note says why the weight comes as its K-major copy wt (N, K)) with the
// dequant fused into the store. At (788, 768, 768) its 156 blocks of 64 x
// 64 are all resident at once on the 132 SMs (32 KB of shared memory and
// 128 threads a block). wgmma (descriptor-built shared-memory layouts) is
// not used: at these shapes the K walk's latency, not the MMA rate, bounds
// the kernel.
//
// N-major entry (photonic_matmul_s8_kernel), K not a multiple of 16
// (MGNet's 196 x 196 score head): the first design, kept unchanged on the
// shared main loop of int8_gemm.cuh. It reads the row-major (K, N) codes
// with synchronous loads and transposes each tile into shared memory.
#include "int8_gemm_kmajor.cuh"   // and int8_gemm.cuh

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

__global__ void __launch_bounds__(repro::km::kThreads)
photonic_matmul_s8_kmajor_kernel(const int8_t* __restrict__ xq,
                                 const int8_t* __restrict__ wt,
                                 const float* __restrict__ sx,
                                 const float* __restrict__ sw,
                                 float* __restrict__ out, int M, int K,
                                 int N) {
  repro::km::DequantEpi epi{sw, out, *sx, N};
  repro::km::gemm_s8_tile(xq, wt, M, K, N, epi);
}

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
  namespace km = repro::km;
  const dim3 grid((N + km::BN - 1) / km::BN, (M + km::BM - 1) / km::BM);
  photonic_matmul_s8_kmajor_kernel<<<grid, km::kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wt),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
