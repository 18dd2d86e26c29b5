// Flash decode for Hopper: one new token's GQA attention against the first
// `length` rows of a KV cache, split across a thread-block cluster. bf16 or
// f32 in and out, f32 inside, on the CUDA cores.
//
// q (B, 1, H, D) contiguous; k_cache and v_cache (B, S, Hkv, D) given by
// their (batch, row, head) element strides with D contiguous, so a layer's
// slice of the stacked (L, B, S, Hkv, D) cache is read where it lies;
// -> o (B, 1, H, D) contiguous. Query head h = kv * G + g reads KV head kv
// (G = H / Hkv).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode_kernel.
//
// What bounds it on an H100: at the LM decode shape (B 4, Hkv 2, 160 of
// 512 cache rows, head dim 128, bf16) a call must read 0.66 MB of K/V:
// 0.2 us at 3.35 TB/s, and does 0.16 MFLOP. So bytes, and far above them
// the latency of the few dependent steps a call needs (launch, load,
// merge). The design cuts those steps:
//
// - One cluster of 8 blocks (__cluster_dims__(8, 1, 1), the portable
//   maximum; 16, non-portable, measured slower) per (batch, kv head): grid
//   (8, B * Hkv), 64 blocks at the decode shape. Block c takes keys
//   [c * chunk, min((c + 1) * chunk, length)), chunk = ceil(length / 8);
//   a block with no keys keeps m = NEG_INF and
//   l = 0. The grid depends on (B, Hkv) only, never on `length` (a host
//   int), so a CUDA graph that puts `length` on the device keeps it.
// - No shared-memory tiles and no serial score chain. Lanes split D into
//   16-byte vectors (8 bf16 or 4 f32): a group of R lanes (R the power of
//   two that covers D's vectors, at most 32) reads one K or V row in one
//   coalesced access, so a warp holds 32 / R keys at once, and each lane
//   has kUnroll of them in flight. The block divides the G query rows by
//   sqrt(D) (__fdiv_rn, the reference's order) once into shared memory, 8
//   rows at a time (a larger G loops over groups of 8), and each lane keeps
//   its slice of them in registers. A row's score is the group's partial
//   dots summed by __shfl_xor, all of a step's (key, row) scores level by
//   level. Each lane group keeps its own running (max, sum, accumulator) in
//   registers; the update has no branch per score (a branch around each
//   exp serializes them, which cost more than the loads).
// - Merge in a fixed order, with no workspace and no atomics: lane groups
//   by shuffles, warps through shared memory, then blocks through
//   distributed shared memory into the cluster's rank 0, which rescales by
//   the global max, divides the accumulator by the sum (as the reference's
//   decode_attention does) and writes o. The result is bitwise the same
//   from run to run and for any strides of the same data.
//
// Numerics against the TPU kernel (one (max, sum, acc) walk over 256-row
// blocks, f32): each split's exp(s - m_split) is rescaled by
// exp(m_split - m), where the reference takes exp(s - m) once; the two
// differ by f32 rounding (a few ulps of each weight), far inside the f32
// tolerance rtol = atol = 2e-5 and the bf16 one of 1 ulp of max |o|.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;       // query rows per pass
constexpr int kUnroll = 2;     // keys in flight per lane group
constexpr int kCluster = 8;    // blocks per (batch, kv head)
constexpr int kMaxParts = 8;   // parts a merge folds: warps, or ranks
static_assert(kWarps <= kMaxParts && kCluster <= kMaxParts, "merge parts");
constexpr float kNegInf = -1e30f;

// 16 bytes of T -> floats
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x; x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One pass state: a lane group's (max, sum) per row and the lane's slice of
// each row's accumulator.
template <int E>
struct State {
  float m[kRows], l[kRows], acc[kRows][E];
};

// fold `o` into `s`: rescale both to the larger max, then add
template <int E>
__device__ __forceinline__ void merge(State<E>& s, const float (&om)[kRows],
                                      const float (&ol)[kRows],
                                      const float (&oacc)[kRows][E]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float m = fmaxf(s.m[r], om[r]);
    const float a = expf(s.m[r] - m), b = expf(om[r] - m);
    s.m[r] = m;
    s.l[r] = s.l[r] * a + ol[r] * b;
#pragma unroll
    for (int e = 0; e < E; ++e) s.acc[r][e] = s.acc[r][e] * a + oacc[r][e] * b;
  }
}

// the n parts' (max, sum) of each row ([part][row]) -> the rows' max m,
// each part's weight exp(m_part - m), and the weighted sum, in part order
__device__ __forceinline__ void weigh(int n, const float* pm, const float* pl,
                                      float* w, float* m_out, float* l_out,
                                      int tid) {
  if (tid < kRows) {
    float m = kNegInf, l = 0.f;
    for (int p = 0; p < n; ++p) m = fmaxf(m, pm[p * kRows + tid]);
    for (int p = 0; p < n; ++p) {
      const float f = expf(pm[p * kRows + tid] - m);
      w[p * kRows + tid] = f;
      l += pl[p * kRows + tid] * f;
    }
    m_out[tid] = m;
    l_out[tid] = l;
  }
}

__device__ __forceinline__ void fma4(float4& a, const float4& x, float f) {
  a.x += x.x * f; a.y += x.y * f; a.z += x.z * f; a.w += x.w * f;
}

// NV: 16-byte vectors per lane per row (1, or 2 for f32 rows of 33-64
// vectors, i.e. head dims 129-256)
template <typename T, int NV>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
flash_decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, T* __restrict__ out,
                            int H, int Hkv, int D, int length, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, float sqrt_d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = NV * VEC;              // floats per lane per row
  extern __shared__ float smem[];
  float* q_s = smem;                       // [kRows][D] q / sqrt(D)
  float* w_m = q_s + kRows * D;            // [kWarps][kRows] warps' maxima
  float* w_l = w_m + kWarps * kRows;       // [kWarps][kRows] and sums
  float* w_acc = w_l + kWarps * kRows;     // [kWarps][kRows][D]
  float* c_acc = w_acc + kWarps * kRows * D;  // the block's merge: [kRows][D]
  float* c_m = c_acc + kRows * D;          // [kRows]
  float* c_l = c_m + kRows;                // [kRows]
  float* wt = c_l + kRows;                 // [kMaxParts][kRows] merge weights
  float* g_m = wt + kMaxParts * kRows;     // [kMaxParts][kRows] ranks' maxima
  float* g_l = g_m + kMaxParts * kRows;    // [kMaxParts][kRows] and sums
  float* f_m = g_l + kMaxParts * kRows;    // [kRows] the cluster's maxima
  float* f_l = f_m + kRows;                // [kRows] and sums

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv;
  const int nvec = D / VEC;                // 16-byte vectors in a row
  int R = 1;                               // lanes per key row
  while (R * NV < nvec) R <<= 1;
  const int li = lane & (R - 1), grp = lane / R;
  const int streams = kWarps * (32 / R);   // lane groups in the block
  const int stream = warp * (32 / R) + grp;

  const int chunk = (length + kCluster - 1) / kCluster;
  const int k0 = rank * chunk, k1 = min(k0 + chunk, length);
  const T* kp = kc + b * ksb + hk * ksh;
  const T* vp = vc + b * vsb + hk * vsh;

  for (int g0 = 0; g0 < G; g0 += kRows) {
    const T* qp = q + ((long long)b * H + (long long)hk * G + g0) * D;
    for (int i = tid; i < kRows * D; i += kThreads) {
      q_s[i] = g0 + i / D < G ? __fdiv_rn(to_f32(qp[i]), sqrt_d) : 0.f;
    }
    __syncthreads();
    float qr[kRows][E];                    // the lane's slice of each row
    State<E> st;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      st.m[r] = kNegInf;
      st.l[r] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int vi = li + n * R;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          qr[r][n * VEC + e] = vi < nvec ? q_s[r * D + vi * VEC + e] : 0.f;
          st.acc[r][n * VEC + e] = 0.f;
        }
      }
    }

    for (int base = k0; base < k1; base += streams * kUnroll) {
      float kx[kUnroll][E], vx[kUnroll][E];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * streams + stream;
        ok[u] = j < k1;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int vi = li + n * R;
          if (ok[u] && vi < nvec) {
            load_vec(kp + j * kss + vi * VEC, &kx[u][n * VEC]);
            load_vec(vp + j * vss + vi * VEC, &vx[u][n * VEC]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kx[u][n * VEC + e] = vx[u][n * VEC + e] = 0.f;
          }
        }
      }
      float sc[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s += qr[r][e] * kx[u][e];
          sc[u][r] = s;
        }
      }
      // the group's partial dots, every (key, row) at once per level
      for (int o = R >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
      }
      // a key past the split scores NEG_INF; exp(NEG_INF - m) is exactly 0
      // at a finite max, and a row that has seen no key subtracts 0
      // instead. No branch per score, so the exps overlap.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mx = st.m[r];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sc[u][r] = ok[u] ? sc[u][r] : kNegInf;
          mx = fmaxf(mx, sc[u][r]);
        }
        const float alpha = expf(st.m[r] - mx);
        const float ms = mx == kNegInf ? 0.f : mx;
        st.m[r] = mx;
        st.l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) st.acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = expf(sc[u][r] - ms);
          st.l[r] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) st.acc[r][e] += p * vx[u][e];
        }
      }
    }

    // lane groups -> the warp's first group, by shuffles
    for (int o = R; o < 32; o <<= 1) {
      float om[kRows], ol[kRows], oacc[kRows][E];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        om[r] = __shfl_xor_sync(0xffffffffu, st.m[r], o);
        ol[r] = __shfl_xor_sync(0xffffffffu, st.l[r], o);
#pragma unroll
        for (int e = 0; e < E; ++e)
          oacc[r][e] = __shfl_xor_sync(0xffffffffu, st.acc[r][e], o);
      }
      merge(st, om, ol, oacc);
    }
    if (grp == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (li == 0) {
          w_m[warp * kRows + r] = st.m[r];
          w_l[warp * kRows + r] = st.l[r];
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int vi = li + n * R;
          if (vi < nvec) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              w_acc[(warp * kRows + r) * D + vi * VEC + e] =
                  st.acc[r][n * VEC + e];
          }
        }
      }
    }
    __syncthreads();

    // warps -> the block, in warp order
    weigh(kWarps, w_m, w_l, wt, c_m, c_l, tid);
    __syncthreads();
    for (int i = tid; i < kRows * D / 4; i += kThreads) {
      const int r = 4 * i / D;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kWarps; ++w)
        fma4(a, reinterpret_cast<const float4*>(w_acc)[w * kRows * D / 4 + i],
             wt[w * kRows + r]);
      reinterpret_cast<float4*>(c_acc)[i] = a;
    }
    cluster.sync();                        // every block's merge is visible

    // blocks -> rank 0, in rank order, through distributed shared memory:
    // the ranks' (max, sum) first, then every rank's slice of each 16-byte
    // accumulator vector in flight at once
    if (rank == 0) {
      if (tid < kCluster * kRows) {
        const int c = tid / kRows, r = tid % kRows;
        g_m[tid] = *cluster.map_shared_rank(c_m + r, c);
        g_l[tid] = *cluster.map_shared_rank(c_l + r, c);
      }
      __syncthreads();
      weigh(kCluster, g_m, g_l, wt, f_m, f_l, tid);
      __syncthreads();
      const int rows = min(kRows, G - g0);
      T* op = out + ((long long)b * H + (long long)hk * G + g0) * D;
      for (int i = tid; i < rows * D / 4; i += kThreads) {
        const int r = 4 * i / D;
        float4 x[kCluster];
#pragma unroll
        for (int c = 0; c < kCluster; ++c)
          x[c] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(c_acc + 4 * i, c));
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kCluster; ++c) fma4(a, x[c], wt[c * kRows + r]);
        const float l = f_l[r];
        store(op + 4 * i, a.x / l);
        store(op + 4 * i + 1, a.y / l);
        store(op + 4 * i + 2, a.z / l);
        store(op + 4 * i + 3, a.w / l);
      }
    }
    cluster.sync();                        // rank 0 is done reading
  }
}

template <typename T, int NV>
int launch_nv(const T* q, const T* kc, const T* vc, T* out,
              const long long* st, int B, int H, int Hkv, int D, int length,
              float sqrt_d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kWarps + 2) * kRows * D +
                                       (size_t)(2 * kWarps + 3 * kMaxParts +
                                                4) * kRows);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_cluster_kernel<T, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // grid x: one cluster of kCluster blocks, as __cluster_dims__ sets
  flash_decode_cluster_kernel<T, NV>
      <<<dim3(kCluster, B * Hkv), kThreads, smem, stream>>>(
          q, kc, vc, out, H, Hkv, D, length, st[0], st[1], st[2], st[3],
          st[4], st[5], sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* out,
           const long long* st, int B, int H, int Hkv, int D, int length,
           float sqrt_d, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = D / VEC;
  if (D % VEC != 0 || nvec > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kc);
  const T* vt = static_cast<const T*>(vc);
  T* ot = static_cast<T*>(out);
  if (nvec <= 32)
    return launch_nv<T, 1>(qt, kt, vt, ot, st, B, H, Hkv, D, length, sqrt_d,
                           s);
  return launch_nv<T, 2>(qt, kt, vt, ot, st, B, H, Hkv, D, length, sqrt_d, s);
}

}  // namespace

// strides: 6 element strides, (batch, row, head) of k_cache then v_cache;
// every pointer and stride 16-byte aligned, D * sizeof(T) a multiple of 16
// and at most 1,024 bytes (the wrapper checks)
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
