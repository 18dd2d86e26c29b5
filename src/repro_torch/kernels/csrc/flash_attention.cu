// RoI-masked bidirectional flash attention for Hopper, f32 end to end.
//
// q (B, H, Sq, D), k (B, Hk, Skv, D), v (B, Hv, Skv, Dv), a (B, Skv) f32
// key keep-mask and per-(batch, kv-tile) live-key counts -> o (B, H, Sq, Dv).
// Query head h reads key head h / (H / Hk) and value head h / (H / Hv).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_masked_kernel.
//
// One block owns one (batch * head, 16-row query tile) and walks the KV
// tiles in a loop: the loop is the TPU grid's sequential KV axis, and the
// running (max, sum, accumulator) state that the TPU kept in VMEM scratch
// lives in shared memory for the whole walk. A KV tile whose live count is
// 0 is skipped before any load: no score, no softmax update, no PV product.
// Inside a live tile masked keys score NEG_INF = -1e30 (not -inf), so every
// row max stays finite and exp(NEG_INF - m) is exactly 0. Rows with no live
// key at all keep l = 0 and write acc / max(l, 1e-30) = exactly 0. expf is
// the accurate libm form (no fast-math intrinsic). Sq and Skv are masked,
// never padded in device memory.
//
// What bounds it on an H100: at serving shapes (4 x 12 heads, 50..197
// tokens, head dim 64) a call reads and writes ~2.5-10 MB and does
// 4 * B * H * Sq * Skv * D = 0.03-0.5 GFLOP of f32 work on the CUDA cores
// (67 TFLOP/s), so both roofs are a few microseconds away and the block's
// serial walk (load, score, warp softmax, PV with a barrier between each)
// bounds it. A 32-key tile makes one warp own one score row, so the row
// max and row sum are warp shuffles with no shared-memory reduction.
// Tensor cores (TF32 or split bf16 mma) and a pipelined K/V ring are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;        // query rows per block
constexpr int kBKV = 32;       // keys per tile, one lane each; = KV_TILE in
                               // kernels/flash_attention.py (live counts)
constexpr int kThreads = 128;  // 4 warps; warp w owns rows w, w + 4, ...
constexpr float kNegInf = -1e30f;

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

__global__ void __launch_bounds__(kThreads)
flash_attention_masked_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ mask,
                              const int* __restrict__ nlive,
                              float* __restrict__ out, int H, int Hk, int Hv,
                              int Sq, int Skv, int D, int Dv, int nkv,
                              float scale) {
  extern __shared__ float smem[];
  const int ldq = D + 1;                   // odd strides: conflict-free columns
  float* Qs = smem;                        // [kBQ][D + 1], pre-scaled
  float* Ks = Qs + kBQ * ldq;              // [kBKV][D + 1]
  float* Vs = Ks + kBKV * ldq;             // [kBKV][Dv]
  float* Ps = Vs + kBKV * Dv;              // [kBQ][kBKV]
  float* Acc = Ps + kBQ * kBKV;            // [kBQ][Dv]
  float* m_s = Acc + kBQ * Dv;             // [kBQ]
  float* l_s = m_s + kBQ;                  // [kBQ]
  float* a_s = l_s + kBQ;                  // [kBQ] per-tile rescale
  int* keep = reinterpret_cast<int*>(a_s + kBQ);  // [kBKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk), hv = h / (H / Hv);
  const int q0 = blockIdx.x * kBQ;
  const float* qp = q + (size_t)bh * Sq * D;
  const float* kp = k + (size_t)(b * Hk + hk) * Skv * D;
  const float* vp = v + (size_t)(b * Hv + hv) * Skv * Dv;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * ldq + d] = (q0 + r < Sq) ? __fmul_rn(qp[(size_t)(q0 + r) * D + d], scale) : 0.0f;
  }
  for (int i = tid; i < kBQ * Dv; i += kThreads) Acc[i] = 0.0f;
  if (tid < kBQ) { m_s[tid] = kNegInf; l_s[tid] = 0.0f; }

  for (int kt = 0; kt < nkv; ++kt) {
    if (nlive[b * nkv + kt] == 0) continue;   // the whole tile is pruned
    const int j0 = kt * kBKV;
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      Ks[j * ldq + d] = (j0 + j < Skv) ? kp[(size_t)(j0 + j) * D + d] : 0.0f;
    }
    for (int i = tid; i < kBKV * Dv; i += kThreads) {
      const int j = i / Dv, c = i % Dv;
      Vs[i] = (j0 + j < Skv) ? vp[(size_t)(j0 + j) * Dv + c] : 0.0f;
    }
    if (tid < kBKV)
      keep[tid] = (j0 + tid < Skv) && (mask[(size_t)b * Skv + j0 + tid] > 0.0f);
    __syncthreads();

    // scores + streaming-softmax update: lane j scores key j0 + j of row r
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += Qs[r * ldq + d] * Ks[lane * ldq + d];
      s = keep[lane] ? s : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      const float alpha = expf(m_prev - m_new);
      Ps[r * kBKV + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
      __syncwarp();
      for (int c = lane; c < Dv; c += 32) {
        float acc = Acc[r * Dv + c] * a_s[r];
        for (int j = 0; j < kBKV; ++j) acc += Ps[r * kBKV + j] * Vs[j * Dv + c];
        Acc[r * Dv + c] = acc;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < kBQ * Dv; i += kThreads) {
    const int r = i / Dv, c = i % Dv;
    if (q0 + r < Sq)
      out[((size_t)bh * Sq + q0 + r) * Dv + c] = Acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)(kBQ + kBKV) * (D + 1) + (size_t)kBKV * Dv +
                          kBQ * kBKV + (size_t)kBQ * Dv + 3 * kBQ + kBKV);
}

}  // namespace

extern "C" int flash_attention_masked_f32(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          const void* nlive, void* out, int B,
                                          int H, int Hk, int Hv, int Sq,
                                          int Skv, int D, int Dv, int nkv,
                                          float scale, void* stream) {
  const size_t smem = smem_bytes(D, Dv);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_masked_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_masked_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const int*>(nlive), static_cast<float*>(out), H, Hk, Hv, Sq,
      Skv, D, Dv, nkv, scale);
  return static_cast<int>(cudaGetLastError());
}
