// Fused int8 photonic GELU-MLP for Hopper, in two launches:
//
//   phase 0: h = gelu_tanh((f32(xq . w1) * sx) * sw1[n] + b1[n]) for every
//            live row, stored f32 to a (M, d_ff) scratch, and the global
//            |h| maximum folded into one device scalar (atomicMax on the
//            int bit pattern, valid for non-negative floats);
//   phase 1: scale2 = max(amax, 1e-8) * f32(1/qmax); every A tile of the
//            hidden state is requantized on load, rintf(h / scale2) clipped
//            to +-qmax, and fed to the w2 int8 GEMM, whose epilogue is the
//            dequant (f32(acc) * scale2) * sw2[n]. b2 is added outside.
//
// Replaces: src/repro/kernels/fused_ffn.py::fused_ffn_kernel.
//
// Two hazards of the TPU kernel, and what this design does about them:
//   * The TPU grid runs in order, so one SMEM scalar carries the running
//     absmax from phase 0 into phase 1. CUDA blocks run concurrently and in
//     no order, so the reduction is a device scalar that phase 0 raises
//     with atomicMax and phase 1 reads after the launch boundary. Rows
//     >= M (m_eff) are never computed, so they never enter the max.
//   * The TPU kernel keeps both weight banks whole in VMEM. Neither fits a
//     block's 227 KB of shared memory (base: 2.25 MiB each), so d_ff is
//     tiled: phase 0 is a (M, d_ff) GEMM over 64 x 64 tiles and phase 1
//     walks d_ff as its K axis. Phase 1 reads back the hidden tile that
//     phase 0 stored in device memory (788 x 3072 x 4 B = 9.7 MB at base,
//     which stays in the 50 MB L2) instead of recomputing it as the TPU
//     kernel does; the requantization is fused into the load.
//
// What bounds it on an H100: 2 GEMMs of 2*M*768*3072 int8 operations each
// (0.9-3.7 GOP at serving M) against ~10-25 MB of traffic counting the
// hidden round trip, so at these sizes the tile walk's latency, not the
// int8 roof, bounds it; keeping the hidden state on chip (recompute, or a
// persistent kernel) is later work.
//
// Numerics: every product and sum of the dequant, bias, GELU and requant
// chain is an explicitly rounded intrinsic, so nothing contracts into an
// FMA. GELU is the tanh form with accurate tanhf (the reference's
// jax.nn.gelu default). The input x is f32 on this path, so the casts to
// x.dtype of the reference are identities.
#include "int8_gemm.cuh"

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // f32(sqrt(2 / pi))
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

// A operand of phase 1: the f32 hidden state (M, F), requantized to int8
// codes at scale2 as each tile is loaded.
struct LoadRequant {
  const float* h;
  int M, F;
  float scale;
  float qmax;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    if (r >= M || c >= F) return 0u;
    const float* p = h + (size_t)r * F + c;
    float v[4];
    if (c + 4 <= F && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (c + i < F) ? p[i] : 0.0f;
    }
    uint32_t out = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -qmax), qmax);
      out |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * i);
    }
    return out;
  }
};

__global__ void __launch_bounds__(repro::kGemmThreads)
fused_ffn_phase0_kernel(const int8_t* __restrict__ xq,
                        const int8_t* __restrict__ w1,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw1,
                        const float* __restrict__ b1,
                        float* __restrict__ hidden, float* amax,
                        int M, int K, int F) {
  const float s = *sx;
  float local = 0.0f;
  repro::gemm_s8_tile(repro::LoadS8{xq, M, K}, w1, M, K, F,
                      [&](int m, int n, int acc) {
                        const float h = __fadd_rn(repro::dequant(acc, s, sw1[n]), b1[n]);
                        const float gl = gelu_tanh(h);
                        hidden[(size_t)m * F + n] = gl;
                        local = fmaxf(local, fabsf(gl));
                      });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((threadIdx.x & 31) == 0)
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(local));
}

__global__ void __launch_bounds__(repro::kGemmThreads)
fused_ffn_phase1_kernel(const float* __restrict__ hidden,
                        const int8_t* __restrict__ w2,
                        const float* __restrict__ amax,
                        const float* __restrict__ sw2,
                        float* __restrict__ out, int M, int F, int N,
                        int qmax, float inv_qmax) {
  const float scale2 = __fmul_rn(fmaxf(*amax, 1e-8f), inv_qmax);
  repro::gemm_s8_tile(
      LoadRequant{hidden, M, F, scale2, (float)qmax}, w2, M, F, N,
      [&](int m, int n, int acc) {
        out[(size_t)m * N + n] = repro::dequant(acc, scale2, sw2[n]);
      });
}

}  // namespace

extern "C" int fused_ffn_phase0(const void* xq, const void* w1, const void* sx,
                                const void* sw1, const void* b1, void* hidden,
                                void* amax, int M, int K, int F, void* stream) {
  const dim3 grid((F + repro::BN - 1) / repro::BN,
                  (M + repro::BM - 1) / repro::BM);
  fused_ffn_phase0_kernel<<<grid, repro::kGemmThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1),
      static_cast<const float*>(sx), static_cast<const float*>(sw1),
      static_cast<const float*>(b1), static_cast<float*>(hidden),
      static_cast<float*>(amax), M, K, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_ffn_phase1(const void* hidden, const void* w2,
                                const void* amax, const void* sw2, void* out,
                                int M, int F, int N, int qmax, float inv_qmax,
                                void* stream) {
  const dim3 grid((N + repro::BN - 1) / repro::BN,
                  (M + repro::BM - 1) / repro::BM);
  fused_ffn_phase1_kernel<<<grid, repro::kGemmThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hidden), static_cast<const int8_t*>(w2),
      static_cast<const float*>(amax), static_cast<const float*>(sw2),
      static_cast<float*>(out), M, F, N, qmax, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}
