// Photonic w8a8 matmul for Hopper: int8 (M, K) . int8 (K, N) -> int32 on the
// tensor cores (mma.sync m16n8k32 s8), then the dequant epilogue
// (f32(acc) * sx) * sw[n] -> f32 (M, N).
//
// Replaces: src/repro/kernels/photonic_matmul.py::photonic_matmul_kernel.
//
// What bounds it on an H100: at the serving shapes (M = 200..1576 token
// rows, K = 768, N = 768) a call moves ~1.4-6.6 MB and does 0.2-1.9 GOP of
// int8 work, so the int8 tensor-core roof (1,979 TOP/s) and the HBM roof
// (3.35 TB/s) are both 1-2 microseconds away: at these sizes the launch
// and the tile walk's latency bound it, not either roof. The design keeps
// the int32 accumulate in registers across the whole K walk (the TPU
// kernel's VMEM scratch), masks ragged M/K/N inside the loaders instead of
// padding to 128 in device memory, and fuses the dequant into the store.
// It does not yet overlap loads with mma (no cp.async/TMA ring, no wgmma):
// that is later work.
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

}  // namespace

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
