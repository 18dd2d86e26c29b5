// Dequant epilogue of an int32 accumulate for Hopper:
// out[m, n] = (f32(acc[m, n]) * sx) * sw[n], acc (M, N) int32 -> out (M, N) f32.
//
// Replaces: src/repro/kernels/fused_ffn.py::_dequant_epilogue_kernel (the
// wrapper `_dequant_epilogue`, called by `_int8_linear_xla` and
// `_int8_linear_sharded`). On the model-sharded FFN it runs twice a layer:
// after w1's local columns, and after the exact int32 all-reduce of w2's
// partial accumulates, which is why it cannot live inside a GEMM's epilogue.
//
// What bounds it on an H100: bytes. Each element reads 4 B and writes 4 B
// and does two multiplies, so at (788, 2048) it moves 12.9 MB (3.9 us at
// 3.35 TB/s) against 3.2 MFLOP (0.05 us at 67 TFLOP/s). The design is the
// plainest stream that reaches the roof: one thread per 4 outputs, a 16-byte
// int4 load of acc and a 16-byte float4 store where N % 4 == 0 and both
// pointers are 16-byte aligned (4 outputs then never cross a row), a scalar
// path for ragged N and the tail. sx is read once per block into shared
// memory; sw is read per column (N floats, L1/L2 resident).
//
// Numerics: repro::dequant, two separately rounded products in the
// reference's order (f32(acc) * sx) * sw; there is no add, so nothing can
// contract into an FMA. Bias and casts stay outside, where the reference
// keeps them: keeping the bias add out of this product is the reason the
// TPU kernel exists (src/repro/kernels/fused_ffn.py:247-257).
#include <cstdint>

#include "int8_gemm.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dequant_epilogue_kernel(const int32_t* __restrict__ acc,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw,
                        float* __restrict__ out, int64_t M, int64_t N,
                        bool vec4) {
  __shared__ float s;
  if (threadIdx.x == 0) s = *sx;
  __syncthreads();
  const int64_t total = M * N;
  const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 >= total) return;
  if (vec4) {
    // N % 4 == 0: the 4 outputs share a row and start at column n0
    const int n0 = (int)(i0 % N);
    const int4 a = *reinterpret_cast<const int4*>(acc + i0);
    float4 o;
    o.x = repro::dequant(a.x, s, sw[n0]);
    o.y = repro::dequant(a.y, s, sw[n0 + 1]);
    o.z = repro::dequant(a.z, s, sw[n0 + 2]);
    o.w = repro::dequant(a.w, s, sw[n0 + 3]);
    *reinterpret_cast<float4*>(out + i0) = o;
    return;
  }
  const int64_t i1 = i0 + 4 < total ? i0 + 4 : total;
  for (int64_t i = i0; i < i1; ++i)
    out[i] = repro::dequant(acc[i], s, sw[i % N]);
}

}  // namespace

extern "C" int dequant_epilogue_s32(const void* acc, const void* sx,
                                    const void* sw, void* out, int M, int N,
                                    void* stream) {
  const int64_t total = (int64_t)M * N;
  const bool vec4 = N % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t per_block = (int64_t)kThreads * 4;
  const int64_t blocks = (total + per_block - 1) / per_block;
  dequant_epilogue_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<float*>(out), M, N, vec4);
  return static_cast<int>(cudaGetLastError());
}
