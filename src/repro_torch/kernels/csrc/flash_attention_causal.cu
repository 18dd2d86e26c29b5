// Causal / local-window GQA flash attention for Hopper: bf16 on the tensor
// cores (the LM prefill's entry), and f32 on the CUDA cores.
//
// q (B, H, Sq, D), k and v (B, Hkv, Skv, D), each given by its (batch,
// head, row) strides with D contiguous, -> o (B, H, Sq, D) by its strides.
// Query head h reads KV head h / (H / Hkv). Query row i sees key j iff
// (!causal || i >= j) && (window == 0 || i - j < window).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_kernel.
//
// bf16 entry (flash_attention_causal_mma_kernel), the FlashAttention-2
// shape. A block of 4 warps owns a 64-row query tile of one (batch, head);
// each warp owns 16 rows (2 warps and 32-row tiles, 192 blocks at the
// prefill shape, measured slower). Q arrives once
// through cp.async and stays in registers as ldmatrix A fragments. K and V
// move in 64-key tiles through a 2-stage cp.async ring in dynamic shared
// memory, 16-byte chunks, the next tile in flight while this one is used;
// rows past Skv are zero-filled through the src-size operand and never
// read. Each row's 16-byte chunk c is stored at c ^ (row & 7), so the
// eight rows an ldmatrix reads fall in eight different bank groups.
// S = Q K^T is mma.sync m16n8k16 bf16 x bf16 -> f32, then times `scale` in
// f32; O += P V takes P from the S accumulators as A fragments (FA2's
// register layout) and V through ldmatrix.trans. Causal and window masks
// are per element, from positions, computed without branches (a branch
// around each exp serializes them); a tile no row of the block can see is
// skipped before its load (the walk runs from the first tile that meets
// the first row's window to the last one at or left of the last row), and
// a warp skips the MMAs of a tile none of its rows can see. The online
// softmax lives in registers: a row's max and sum by quad shuffles, expf,
// NEG_INF = -1e30, p exactly 0 for hidden keys, so a row with no visible
// key keeps l = 0 and writes exactly 0 (o times 1 / max(l, 1e-30)). D in
// {16, 64, 128}; the wrapper raises on any other D and on 16-byte
// misalignment.
//
// Numerics against the TPU kernel, which scales q in f32 and multiplies in
// f32: here q and k are bf16, so each product q_d k_d is exact in f32 and
// the two orders differ only in f32 rounding of the sum and the scale.
// P is split into hi = bf16(p) and lo = bf16(p - hi), and O += hi V + lo V
// (two MMAs): hi + lo carries p to ~2^-18 relative, f32 class, so the PV
// product is as accurate as the TPU kernel's f32 dot. The epilogue
// multiplies by 1 / l where the TPU kernel divides: 1 f32 ulp. The bf16
// output is held to 1 bf16 ulp of max |o| against the plain f32 version.
//
// What bounds it on an H100: at the LM prefill shape (4 x 12 heads, 128
// tokens, head dim 128, bf16, causal) a call must move 3.67 MB (q, k, v
// read once, o written once): 1.10 us at 3.35 TB/s; the visible pairs are
// 0.20 GFLOP, 0.21 us on the bf16 tensor cores: bytes bound it. The
// cp.async ring keeps the next tile's bytes in flight under this tile's
// MMAs; 16-byte chunks coalesce each K/V row. What holds the kernel above
// that bound is latency: a block's walk (load, S, softmax, PV, tile by
// tile) runs one warp on each SM sub-partition, so nothing hides it.
// wgmma and TMA pay off where MMA throughput or address generation bound
// the kernel (long prompts), which is later work.
//
// f32 entry (flash_attention_causal_kernel): the first CUDA design, a SIMT
// kernel kept unchanged for f32 callers; no main path launches it. One block owns a
// 16-row query tile and walks 32-key tiles, scalar loads into shared
// memory, one warp per score row, f32 FMAs on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {        // element strides of a (batch, head, row) walk
  long long b, h, s;
};

__device__ __forceinline__ bool visible(int i, int j, int Skv, int causal,
                                        int window) {
  return (j < Skv) & (!causal | (i >= j)) & ((window <= 0) | (i - j < window));
}

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 16;        // query rows per block
constexpr int kBKV = 32;       // keys per tile, one lane each
constexpr int kThreads = 128;  // 4 warps; warp w owns rows w, w + 4, ...

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
flash_attention_causal_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ out, Strides qs, Strides ks,
                              Strides vs, Strides os, int H, int Hkv, int Sq,
                              int Skv, int D, int causal, int window,
                              float scale) {
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
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * ld + d] = (q0 + r < Sq) ? __fmul_rn(qp[(q0 + r) * qs.s + d], scale)
                                   : 0.0f;
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
      Ks[j * ld + d] = in ? kp[(j0 + j) * ks.s + d] : 0.0f;
      Vs[i] = in ? vp[(j0 + j) * vs.s + d] : 0.0f;
    }
    __syncthreads();

    // scores + streaming-softmax update: lane j scores key j0 + j of row r
    const int kj = j0 + lane;
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const int qi = q0 + r;
      const bool ok = visible(qi, kj, Skv, causal, window);
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

  float* op = out + b * os.b + h * os.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq)
      op[(q0 + r) * os.s + c] = Acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

int launch(const float* q, const float* k, const float* v, float* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int Hkv, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kBQ + kBKV) * (D + 1) + (size_t)kBKV * D + kBQ * kBKV +
       (size_t)kBQ * D + 2 * kBQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_causal_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_causal_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, out, qs, ks, vs, os, H, Hkv, Sq, Skv, D, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores, a cp.async K/V ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBKV = 64;       // keys per tile: 8 n-tiles of the S product
constexpr int kWarps = 4;      // a block's warps, 16 query rows each
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kNT = 32 * kWarps;   // threads per block

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
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (x in the low half: the lower column of a fragment)
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the residual p - bf16(p) of each of two floats, as bf16x2
__device__ __forceinline__ uint32_t pack_lo(float x, float y) {
  return pack(x - __bfloat162float(__float2bfloat16_rn(x)),
              y - __bfloat162float(__float2bfloat16_rn(y)));
}

// byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = D / 8;
  constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  return r * (D * 2) + ((c ^ (r & kMask)) << 4);
}

// rows [row0, row0 + ROWS) of a (row stride rs) bf16 matrix into a tile;
// rows >= limit are zero-filled
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long rs, int row0, int limit,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async16(dst + swz<D>(r, c), base + (in ? row0 + r : 0) * rs + c * 8,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kNT)
flash_attention_causal_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  __nv_bfloat16* __restrict__ out, Strides qs,
                                  Strides ks, Strides vs, Strides os, int H,
                                  int Hkv, int Sq, int Skv, int causal,
                                  int window, float scale) {
  constexpr int kKSteps = D / 16;          // k-steps of Q K^T
  constexpr int kDTiles = D / 8;           // n-tiles of P V
  constexpr int kTileBytes = kBKV * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sKV = sQ + kBQ * D * 2;   // stage s: K at +2s, V at +2s+1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;  // the block's last real row
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;

  // the live tiles [t_lo, t_hi): from the one holding the first row's
  // first visible key to the one holding the last row's last
  const int nkv = (Skv + kBKV - 1) / kBKV;
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / kBKV : 0;
  const int t_hi = causal ? min(nkv, q_hi / kBKV + 1) : nkv;

  if (t_lo < t_hi) {                       // else no row sees a key: o = 0
    load_tile<D, kBQ, kNT>(sQ, qp, qs.s, q0, Sq, tid);
    load_tile<D, kBKV, kNT>(sKV, kp, ks.s, t_lo * kBKV, Skv, tid);
    load_tile<D, kBKV, kNT>(sKV + kTileBytes, vp, vs.s, t_lo * kBKV, Skv,
                            tid);
  }
  cp_async_commit();

  const int w0 = q0 + warp * 16;           // the warp's first row
  const int row_a = w0 + (lane >> 2), row_b = row_a + 8;
  const int col = 2 * (lane & 3);          // a fragment's column pair
  uint32_t qf[kKSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t sK = sKV + ((t - t_lo) & 1) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    if (t + 1 < t_hi) {                    // the next tile into the other stage
      const uint32_t nK = sKV + ((t + 1 - t_lo) & 1) * 2 * kTileBytes;
      load_tile<D, kBKV, kNT>(nK, kp, ks.s, (t + 1) * kBKV, Skv, tid);
      load_tile<D, kBKV, kNT>(nK + kTileBytes, vp, vs.s, (t + 1) * kBKV, Skv,
                              tid);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();           // this tile (and Q) have landed
    __syncthreads();

    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], sQ + swz<D>(warp * 16 + (lane & 15),
                                        2 * kk + (lane >> 4)));
    }
    const int j0 = t * kBKV;
    const bool live = w0 < Sq && (!causal || j0 <= w0 + 15) &&
                      (window <= 0 || j0 + kBKV - 1 > w0 - window);
    // every row of the warp sees every key of the tile: no per-key mask
    const bool all = j0 + kBKV <= Skv && (!causal || j0 + kBKV - 1 <= w0) &&
                     (window <= 0 || w0 + 15 - j0 < window);
    if (live) {
      // S = Q K^T: 8 n-tiles of 8 keys; ldmatrix x4 gives two n-tiles' B
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kk + ((lane >> 3) & 1)));
          mma(s[2 * np], qf[kk], bk[0], bk[1]);
          mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // scale, mask, the rows' maxima (a row's values sit in one quad)
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? row_a : row_b, j = j0 + n * 8 + col + (e & 1);
          s[n][e] = (all | visible(i, j, Skv, causal, window))
                        ? s[n][e] * scale : kNegInf;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      // exp(NEG_INF - m) is exactly 0 at a finite max; a row that has seen
      // no key yet subtracts 0 instead, so its hidden keys give 0 too. No
      // branch per element: the exps of a row overlap.
      const float ms_a = mn_a == kNegInf ? 0.f : mn_a;
      const float ms_b = mn_b == kNegInf ? 0.f : mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = expf(s[n][e] - (e < 2 ? ms_a : ms_b));
        sum_a += s[n][0] + s[n][1];
        sum_b += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
      }
      m_a = mn_a; m_b = mn_b;
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        o[n][0] *= al_a; o[n][1] *= al_a;
        o[n][2] *= al_b; o[n][3] *= al_b;
      }
      // O += P V, P as bf16 hi + lo A fragments straight from S
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const int n0 = 2 * kk, n1 = 2 * kk + 1;
        const uint32_t hi[4] = {
            pack(s[n0][0], s[n0][1]), pack(s[n0][2], s[n0][3]),
            pack(s[n1][0], s[n1][1]), pack(s[n1][2], s[n1][3])};
        const uint32_t lo[4] = {
            pack_lo(s[n0][0], s[n0][1]), pack_lo(s[n0][2], s[n0][3]),
            pack_lo(s[n1][0], s[n1][1]), pack_lo(s[n1][2], s[n1][3])};
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + swz<D>(kk * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8,
                                            2 * dp + (lane >> 4)));
          mma(o[2 * dp], hi, bv[0], bv[1]);
          mma(o[2 * dp], lo, bv[0], bv[1]);
          mma(o[2 * dp + 1], hi, bv[2], bv[3]);
          mma(o[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                       // this stage is free to refill
  }

  __nv_bfloat16* op = out + b * os.b + h * os.h;
  const float r_a = 1.f / fmaxf(l_a, 1e-30f), r_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int c = n * 8 + col;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(op + row_a * os.s + c) =
          pack(o[n][0] * r_a, o[n][1] * r_a);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(op + row_b * os.s + c) =
          pack(o[n][2] * r_b, o[n][3] * r_b);
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, Strides qs, Strides ks,
           Strides vs, Strides os, int B, int H, int Hkv, int Sq, int Skv,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(kBQ + 4 * kBKV) * D * 2;  // Q + 2 x (K + V)
  // set once per instantiation: a CUDA runtime call on every launch would
  // add host time to each call
  static const cudaError_t attr =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(flash_attention_causal_mma_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)
          : cudaSuccess;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_causal_mma_kernel<D><<<grid, kNT, smem, stream>>>(
      q, k, v, out, qs, ks, vs, os, H, Hkv, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* out, Strides qs,
             Strides ks, Strides vs, Strides os, int B, int H, int Hkv,
             int Sq, int Skv, int D, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, Sq,
                               Skv, causal, window, scale, stream);
    case 64: return launch<64>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, Sq,
                               Skv, causal, window, scale, stream);
    case 128: return launch<128>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, Sq,
                                 Skv, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v, out in turn
extern "C" int flash_attention_causal_f32(const void* q, const void* k,
                                          const void* v, void* out,
                                          const long long* strides, int B,
                                          int H, int Hkv, int Sq, int Skv,
                                          int D, int causal, int window,
                                          float scale, void* stream) {
  return simt::launch(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out),
                      at(strides, 0), at(strides, 1), at(strides, 2),
                      at(strides, 3), B, H, Hkv, Sq, Skv, D, causal, window,
                      scale, static_cast<cudaStream_t>(stream));
}

// D in {16, 64, 128}, every pointer and stride 16-byte aligned (the wrapper
// checks both)
extern "C" int flash_attention_causal_bf16(const void* q, const void* k,
                                           const void* v, void* out,
                                           const long long* strides, int B,
                                           int H, int Hkv, int Sq, int Skv,
                                           int D, int causal, int window,
                                           float scale, void* stream) {
  using bf = __nv_bfloat16;
  return tc::launch_d(static_cast<const bf*>(q), static_cast<const bf*>(k),
                      static_cast<const bf*>(v), static_cast<bf*>(out),
                      at(strides, 0), at(strides, 1), at(strides, 2),
                      at(strides, 3), B, H, Hkv, Sq, Skv, D, causal, window,
                      scale, static_cast<cudaStream_t>(stream));
}
