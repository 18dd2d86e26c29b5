// Fused int8 photonic GELU-MLP for Hopper:
//
//   h  = gelu_tanh((f32(xq . w1) * sx) * sw1[n] + b1[n]) over the live rows;
//   scale2 = max(max |h|, 1e-8) * f32(1/qmax);  hq = clip(rint(h / scale2));
//   y  = (f32(hq . w2) * scale2) * sw2[n]; b2 is added outside.
//
// Replaces: src/repro/kernels/fused_ffn.py::fused_ffn_kernel.
//
// K-major entry (d_in and d_ff multiples of 16), three launches:
//   phase 0 (fused_ffn_kmajor_phase0_kernel): xq (M, d_in) . w1t (d_ff,
//     d_in)^T on the shared K-major main loop of int8_gemm_kmajor.cuh;
//     dequant -> + b1 -> GELU in the epilogue, stored as f32 pairs to a
//     (M, d_ff) scratch; |h| folded into a device scalar (warp max, then
//     atomicMax on the int bit pattern, valid for non-negative floats);
//   requant (fused_ffn_requant_kernel): scale2 from that scalar, written
//     once to a second scalar, and every hidden value requantized once, 16
//     values a thread (four 16-byte reads, one 16-byte write). The row-major
//     (M, d_ff) codes are phase 1's K-major A operand;
//   phase 1 (fused_ffn_kmajor_phase1_kernel): hq . w2t (d_out, d_ff)^T on
//     the same main loop, dequant at scale2 in the epilogue.
// Both weights come as their K-major copies (QuantizedWeight.wt), made once
// with the cache entry; the wrapper never transposes a weight.
//
// Why three launches. The TPU grid runs in order, so one SMEM scalar
// carries the running absmax from phase 0 into phase 1, and both weight
// banks sit whole in VMEM. CUDA blocks run concurrently and in no order,
// and neither bank fits a block's 227 KB of shared memory (base: 2.25 MiB
// each), so d_ff is tiled and the global max needs a launch boundary: no
// hidden value can be quantized before phase 0 has finished. The requant
// runs once, not once per output tile of phase 1 as a requantizing A
// loader would (12 times at d_out = 768). Rows >= M (m_eff) are never
// computed, so they never enter the max. The f32 hidden state (788 x 3072
// x 4 B = 9.7 MB at base) and its codes (2.4 MB) stay inside the 50 MB L2
// between the launches.
//
// What bounds each launch on an H100 at x (4, 197, 768), d_ff 3072 (M =
// 788): each GEMM is 3.7 GOP of int8 work (1.9 us at 1,979 TOP/s). Phase 0
// writes the 9.7 MB hidden state (2.9 us at 3.35 TB/s, less where it stays
// in L2) and evaluates 2.4 M accurate tanhf; its 624 blocks of 64 x 64 walk
// K = 768 in 12 steps. The requant moves 12.1 MB (3.6 us at HBM rates) and
// divides 2.4 M times. Phase 1 has 156 blocks walking K = 3072 in 48 steps:
// the K walk's latency bounds it, as it bounds B1.
//
// N-major entry (fused_ffn_phase0_kernel, fused_ffn_phase1_kernel), other
// widths: the first design on the main loop of int8_gemm.cuh, kept
// unchanged. It reads the row-major (K, N) codes with synchronous loads,
// transposes each tile into shared memory, and requantizes the f32 hidden
// state in phase 1's A loader as each tile is loaded.
//
// Numerics (both entries alike, so their outputs are bitwise equal): the
// int32 accumulates are exact in any order; every product and sum of the
// dequant, bias, GELU and requant chain is an explicitly rounded
// intrinsic, so nothing contracts into an FMA; the requant divides
// (__fdiv_rn), as the reference's round(g / scale2) does; the max is
// order-free. GELU is the tanh form with accurate tanhf (the reference's
// jax.nn.gelu default). The input x is f32 on this path, so the casts to
// x.dtype of the reference are identities.
#include "int8_gemm_kmajor.cuh"   // and int8_gemm.cuh

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // f32(sqrt(2 / pi))
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

// Four hidden values -> four int8 codes rint(h / scale) clipped to
// +-qmax, packed little-endian into one word.
__device__ __forceinline__ uint32_t requant4(float h0, float h1, float h2,
                                             float h3, float scale,
                                             float qmax) {
  const float v[4] = {h0, h1, h2, h3};
  uint32_t out = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -qmax), qmax);
    out |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * i);
  }
  return out;
}

// N-major phase 1's A operand: the f32 hidden state (M, F), requantized to int8
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
    return requant4(v[0], v[1], v[2], v[3], scale, qmax);
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

// ---- K-major entry -----------------------------------------------------

constexpr int kRequantThreads = 256;

// phase 0's epilogue: dequant -> + b1 -> GELU, stored as f32 pairs, |h|
// folded into the thread's running max
struct GeluEpi {
  const float* sw1;
  const float* b1;
  float* hidden;
  float s;
  int F;
  float local;
  __device__ __forceinline__ float4 column(int n) const {
    const bool two = n + 1 < F;
    return make_float4(__ldg(sw1 + n), __ldg(b1 + n),
                       two ? __ldg(sw1 + n + 1) : 0.f,
                       two ? __ldg(b1 + n + 1) : 0.f);
  }
  __device__ __forceinline__ void operator()(int m, int n, float4 c, int a0,
                                             int a1) {
    const float g0 = gelu_tanh(__fadd_rn(repro::dequant(a0, s, c.x), c.y));
    const float g1 = gelu_tanh(__fadd_rn(repro::dequant(a1, s, c.z), c.w));
    repro::km::store_pair(hidden, m, n, F, g0, g1);
    local = fmaxf(local, fmaxf(fabsf(g0), fabsf(g1)));   // g1 is 0 past F
  }
};

__global__ void __launch_bounds__(repro::km::kThreads)
fused_ffn_kmajor_phase0_kernel(const int8_t* __restrict__ xq,
                               const int8_t* __restrict__ w1t,
                               const float* __restrict__ sx,
                               const float* __restrict__ sw1,
                               const float* __restrict__ b1,
                               float* __restrict__ hidden, float* amax,
                               int M, int K, int F) {
  GeluEpi epi{sw1, b1, hidden, *sx, F, 0.0f};
  repro::km::gemm_s8_tile(xq, w1t, M, K, F, epi);
  float local = epi.local;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((threadIdx.x & 31) == 0)
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(local));
}

// scal[0] = max |h| (from phase 0), scal[1] <- scale2; hq = codes of the
// n16 * 16 hidden values (M * F, a multiple of 16, 16-byte aligned)
__global__ void __launch_bounds__(kRequantThreads)
fused_ffn_requant_kernel(const float* __restrict__ hidden, float* scal,
                         int8_t* __restrict__ hq, long long n16, int qmax,
                         float inv_qmax) {
  const float scale2 = __fmul_rn(fmaxf(scal[0], 1e-8f), inv_qmax);
  const long long c = (long long)blockIdx.x * kRequantThreads + threadIdx.x;
  if (c == 0) scal[1] = scale2;
  if (c >= n16) return;
  const float q = (float)qmax;
  const float4* p = reinterpret_cast<const float4*>(hidden) + 4 * c;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldcs(p + i);          // read once: stream it
    w[i] = requant4(f.x, f.y, f.z, f.w, scale2, q);
  }
  reinterpret_cast<uint4*>(hq)[c] = make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(repro::km::kThreads)
fused_ffn_kmajor_phase1_kernel(const int8_t* __restrict__ hq,
                               const int8_t* __restrict__ w2t,
                               const float* __restrict__ scale2,
                               const float* __restrict__ sw2,
                               float* __restrict__ out, int M, int F, int N) {
  repro::km::DequantEpi epi{sw2, out, *scale2, N};
  repro::km::gemm_s8_tile(hq, w2t, M, F, N, epi);
}

}  // namespace

// ---- N-major entry (the first design): any widths -----------------------

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

// K-major entry: xq (M, K), w1t (F, K), w2t (N, F) row-major int8, K and F
// multiples of 16, every operand 16-byte aligned (the wrapper checks);
// hidden (M, F) f32 and hq (M, F) int8 scratch; scal 2 f32, zeroed.
extern "C" int fused_ffn_kmajor(const void* xq, const void* w1t,
                                const void* sx, const void* sw1,
                                const void* b1, const void* w2t,
                                const void* sw2, void* hidden, void* hq,
                                void* scal, void* out, int M, int K, int F,
                                int N, int qmax, float inv_qmax,
                                void* stream) {
  namespace km = repro::km;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scal);
  fused_ffn_kmajor_phase0_kernel<<<dim3((F + km::BN - 1) / km::BN,
                                        (M + km::BM - 1) / km::BM),
                                   km::kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(sx), static_cast<const float*>(sw1),
      static_cast<const float*>(b1), static_cast<float*>(hidden), sc, M, K,
      F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n16 = (long long)M * F / 16;
  fused_ffn_requant_kernel<<<(unsigned)((n16 + kRequantThreads - 1) /
                                        kRequantThreads),
                             kRequantThreads, 0, st>>>(
      static_cast<const float*>(hidden), sc, static_cast<int8_t*>(hq), n16,
      qmax, inv_qmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ffn_kmajor_phase1_kernel<<<dim3((N + km::BN - 1) / km::BN,
                                        (M + km::BM - 1) / km::BM),
                                   km::kThreads, 0, st>>>(
      static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w2t),
      sc + 1, static_cast<const float*>(sw2), static_cast<float*>(out), M, F,
      N);
  return static_cast<int>(cudaGetLastError());
}
