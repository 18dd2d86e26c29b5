// Causal / local-window GQA flash attention for Hopper: bf16 or f32 in and
// out, f32 inside.
//
// q (B, H, Sq, D), k and v (B, Hkv, Skv, D), each given by its (batch,
// head, row) strides with D contiguous, -> o (B, H, Sq, D) by its strides.
// Query head h reads KV head h / (H / Hkv). Query row i sees key j iff
// (!causal || i >= j) && (window == 0 || i - j < window).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_kernel.
//
// The layout is the masked kernel's (csrc/flash_attention.cu): one block
// owns one (batch * head, 16-row query tile) and walks 32-key tiles in a
// loop that stands in for the TPU grid's sequential KV axis, keeping the
// running (max, sum, accumulator) in shared memory. One warp owns one
// score row per tile, so the row max and sum are warp shuffles. A tile
// that no row of the block can see is skipped before any load: under
// causal masking the walk stops at the first tile past the block's last
// row (kv_lo > q_hi), and under a window a tile wholly left of the first
// row's window (kv_lo + 31 <= q_lo - window) is passed over. Inside a live
// tile hidden keys score NEG_INF = -1e30 and get probability exactly 0, so
// a row with no visible key keeps l = 0 and writes exactly 0. expf is the
// accurate libm form. Sq and Skv are masked, never padded in memory. The
// TPU kernel multiplies q by `scale`; so does this one (__fmul_rn).
//
// What bounds it on an H100: at the LM prefill shape (4 x 12 heads, 128
// tokens, head dim 128, bf16) a call moves ~1.6 MB and does ~0.2 GFLOP of
// causal f32 work on the CUDA cores (67 TFLOP/s): both roofs are a few
// microseconds away, so launch latency and the block's serial walk (load,
// score, softmax, PV, with a barrier between tiles) bound it. At head dim
// 128 the tiles take ~50 KB of shared memory, above the 48 KB static
// limit: they are dynamic, with cudaFuncSetAttribute. Tensor cores
// (wgmma on bf16) and a TMA-fed K/V ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;        // query rows per block
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

struct Strides {        // element strides of a (batch, head, row) walk
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_causal_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              Strides qs, Strides ks, Strides vs, Strides os,
                              int H, int Hkv, int Sq, int Skv, int D,
                              int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;                    // odd stride: conflict-free columns
  float* Qs = smem;                        // [kBQ][D + 1], pre-scaled
  float* Ks = Qs + kBQ * ld;               // [kBKV][D + 1]
  float* Vs = Ks + kBKV * ld;              // [kBKV][D]
  float* Ps = Vs + kBKV * D;               // [kBQ][kBKV]
  float* Acc = Ps + kBQ * kBKV;            // [kBQ][D]
  float* m_s = Acc + kBQ * D;              // [kBQ]
  float* l_s = m_s + kBQ;                  // [kBQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;  // the block's last real row
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * ld + d] = (q0 + r < Sq)
        ? __fmul_rn(to_f32(qp[(q0 + r) * qs.s + d]), scale) : 0.0f;
  }
  for (int i = tid; i < kBQ * D; i += kThreads) Acc[i] = 0.0f;
  if (tid < kBQ) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }

  const int nkv = (Skv + kBKV - 1) / kBKV;
  for (int kt = 0; kt < nkv; ++kt) {
    const int j0 = kt * kBKV;
    if (causal && j0 > q_hi) break;                     // this and all later
    if (window > 0 && j0 + kBKV - 1 <= q0 - window) continue;  // left of window
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = j0 + j < Skv;
      Ks[j * ld + d] = in ? to_f32(kp[(j0 + j) * ks.s + d]) : 0.0f;
      Vs[i] = in ? to_f32(vp[(j0 + j) * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    // scores + streaming-softmax update: lane j scores key j0 + j of row r
    const int kj = j0 + lane;
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const int qi = q0 + r;
      const bool ok = kj < Skv && (!causal || qi >= kj) &&
                      (window <= 0 || qi - kj < window);
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

  T* op = out + b * os.b + h * os.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq)
      op[(q0 + r) * os.s + c] = from_f32<T>(Acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + kBKV) * (D + 1) + (size_t)kBKV * D +
                          kBQ * kBKV + (size_t)kBQ * D + 2 * kBQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int H, int Hkv, int Sq, int Skv, int D,
           int causal, int window, float scale, void* stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_causal_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_causal_kernel<T><<<grid, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H, Hkv,
      Sq, Skv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v, out in turn
extern "C" int flash_attention_causal_f32(const void* q, const void* k,
                                          const void* v, void* out,
                                          const long long* strides, int B,
                                          int H, int Hkv, int Sq, int Skv,
                                          int D, int causal, int window,
                                          float scale, void* stream) {
  return launch<float>(q, k, v, out, strides, B, H, Hkv, Sq, Skv, D, causal,
                       window, scale, stream);
}

extern "C" int flash_attention_causal_bf16(const void* q, const void* k,
                                           const void* v, void* out,
                                           const long long* strides, int B,
                                           int H, int Hkv, int Sq, int Skv,
                                           int D, int causal, int window,
                                           float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, strides, B, H, Hkv, Sq, Skv, D,
                               causal, window, scale, stream);
}
