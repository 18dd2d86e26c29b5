// Flash decode for Hopper: one new token's GQA attention against the first
// `length` rows of a KV cache. bf16 or f32 in and out, f32 inside.
//
// q (B, 1, H, D) contiguous; k_cache and v_cache (B, S, Hkv, D) given by
// their (batch, row, head) element strides with D contiguous, so a layer's
// slice of the stacked (L, B, S, Hkv, D) cache is read where it lies;
// -> o (B, 1, H, D) contiguous. Query head h = kv * G + g reads KV head kv
// (G = H / Hkv).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode_kernel.
//
// One block per (batch, kv head) holds the G query rows of that group
// (G = 6 for qwen2-1.5b) and walks the cache in 32-key tiles up to
// `length` only: a tile past it is never read, and inside the last tile
// rows >= length score NEG_INF = -1e30 with probability exactly 0. The
// running (max, sum, accumulator) stay in shared memory; one warp owns
// one query row per tile, so the row max and sum are warp shuffles. The
// TPU wrapper transposes the cache to (B * Hkv, S, D) before its grid;
// here the strides do that, so no step copies the cache. q is divided by
// sqrt(D) (__fdiv_rn) and the accumulator by the sum at the end, in the
// order of the reference's decode_attention. Any S is taken (masked, not
// padded); `length` is a host int, so a decode loop never waits on the
// card to learn it. expf is the accurate libm form.
//
// What bounds it on an H100: at the LM decode shape (B 4, Hkv 2, 160 of
// 512 cache rows, head dim 128, bf16) a call must read 0.66 MB of K/V:
// 0.2 us at 3.35 TB/s. B * Hkv = 8 blocks on 132 SMs, each walking its
// tiles serially, so launch latency and the walk bound it; splitting S
// across blocks (split-K flash decoding with a merge) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBKV = 32;       // keys per tile, one lane each
constexpr int kThreads = 128;  // 4 warps; warp w owns rows w, w + 4, ...
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ out, int H,
                    int Hkv, int D, int length, long long ksb, long long kss,
                    long long ksh, long long vsb, long long vss, long long vsh,
                    float sqrt_d) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int ld = D + 1;                    // odd stride: conflict-free columns
  float* Qs = smem;                        // [G][D + 1], divided by sqrt(D)
  float* Ks = Qs + G * ld;                 // [kBKV][D + 1]
  float* Vs = Ks + kBKV * ld;              // [kBKV][D]
  float* Ps = Vs + kBKV * D;               // [G][kBKV]
  float* Acc = Ps + G * kBKV;              // [G][D]
  float* m_s = Acc + G * D;                // [G]
  float* l_s = m_s + G;                    // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const T* qp = q + ((long long)b * H + (long long)hk * G) * D;
  const T* kp = kc + b * ksb + hk * ksh;
  const T* vp = vc + b * vsb + hk * vsh;

  for (int i = tid; i < G * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * ld + d] = __fdiv_rn(to_f32(qp[i]), sqrt_d);
    Acc[i] = 0.0f;
  }
  if (tid < G) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }

  const int ntiles = (length + kBKV - 1) / kBKV;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kBKV;
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = j0 + j < length;
      Ks[j * ld + d] = in ? to_f32(kp[(j0 + j) * kss + d]) : 0.0f;
      Vs[i] = in ? to_f32(vp[(j0 + j) * vss + d]) : 0.0f;
    }
    __syncthreads();

    const bool ok = j0 + lane < length;
    for (int r = warp; r < G; r += kThreads / 32) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += Qs[r * ld + d] * Ks[lane * ld + d];
      s = ok ? s : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.0f;
      const float psum = warp_sum(p);
      const float alpha = expf(m_prev - m_new);
      Ps[r * kBKV + lane] = p;
      __syncwarp();
      for (int c = lane; c < D; c += 32) {
        float acc = Acc[r * D + c] * alpha;
        for (int j = 0; j < kBKV; ++j) acc += Ps[r * kBKV + j] * Vs[j * D + c];
        Acc[r * D + c] = acc;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
  }
  __syncthreads();

  T* op = out + ((long long)b * H + (long long)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    op[i] = from_f32<T>(Acc[i] / l_s[i / D]);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)(G + kBKV) * (D + 1) + (size_t)kBKV * D +
                          (size_t)G * kBKV + (size_t)G * D + 2 * G);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* out,
           const long long* st, int B, int H, int Hkv, int D, int length,
           float sqrt_d, void* stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_kernel<T><<<B * Hkv, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), H, Hkv, D, length,
      st[0], st[1], st[2], st[3], st[4], st[5], sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 6 element strides, (batch, row, head) of k_cache then v_cache
extern "C" int flash_decode_f32(const void* q, const void* kc, const void* vc,
                                void* out, const long long* strides, int B,
                                int H, int Hkv, int D, int length,
                                float sqrt_d, void* stream) {
  return launch<float>(q, kc, vc, out, strides, B, H, Hkv, D, length, sqrt_d,
                       stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* kc, const void* vc,
                                 void* out, const long long* strides, int B,
                                 int H, int Hkv, int D, int length,
                                 float sqrt_d, void* stream) {
  return launch<__nv_bfloat16>(q, kc, vc, out, strides, B, H, Hkv, D, length,
                               sqrt_d, stream);
}
