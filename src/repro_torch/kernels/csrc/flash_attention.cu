// RoI-masked bidirectional flash attention for Hopper, f32 end to end.
//
// q (B, H, Sq, D), k (B, Hk, Skv, D), v (B, Hv, Skv, Dv), a key keep-mask
// and per-(batch, kv-tile) live-key counts -> o (B, H, Sq, Dv). Query head
// h reads key head h / (H / Hk) and value head h / (H / Hv).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_masked_kernel.
//
// Both entries walk the KV tiles of one query tile in a loop inside the
// block: the loop is the TPU grid's sequential KV axis, and the running
// (max, sum, accumulator) state the TPU kept in VMEM scratch stays on chip
// for the whole walk. A KV tile whose live count is 0 is skipped before
// any load: no score, no softmax update, no PV product. Inside a live tile
// masked keys score NEG_INF = -1e30 (not -inf), so every row max stays
// finite and exp(NEG_INF - m) is exactly 0; rows with no live key at all
// keep l = 0 and write acc / max(l, 1e-30) = exactly 0. expf is the
// accurate libm form (no fast-math intrinsic). Sq and Skv are masked, never
// padded in device memory.
//
// Tensor-core entry (flash_attention_masked_tc_kernel), D = Dv = 64: every
// ViT width the repo serves. What bounds it on an H100: at the serving
// shape (4 x 12 heads, 197 tokens) a call must move 9.68 MB (q, k, v read
// once, o written once): 2.9 us at 3.35 TB/s; its 0.477 GFLOP take 7.1 us
// on the f32 CUDA cores, 2.9 us as three TF32 passes (495 TFLOP/s). So the
// design takes the tensor cores in f32 class: each f32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), both rounded as cvt.rna rounds,
// and S = Q K^T and O += P V are each lo.hi + hi.lo + hi.hi on mma.sync
// m16n8k8 tf32 with f32 accumulators (3xTF32: the dropped lo.lo term and
// lo's rounding are ~2^-21 of each product; one TF32 pass, 2^-11, misses
// the 2e-5 class by ~10x at D = 64). The split is two integer operations a
// rounding: cvt.rna.tf32.f32 compiles to a longer sequence with NaN
// handling. q is scaled in f32 before its split, as the TPU kernel scales
// it, and stays in shared memory: each warp splits its 16 rows again per
// KV tile (32 values a lane) rather than hold them in 64 registers. A
// block of 4 warps owns a 64-row query tile (192 blocks at the serving
// shape, all resident at once); 32-key K/V tiles (KV_TILE in
// kernels/flash_attention.py) and the tile's keep flags move through a
// 2-stage cp.async ring of 16-byte chunks, the next live tile in flight
// under this one's MMAs; rows past Skv are zero-filled. Measured against
// this shape at S = 50..197 (scripts/vit_kernel_scan.py's sizes): 64-key
// tiles (189 registers, 5-8% slower), 2- and 8-warp blocks, two m-tiles a
// warp (spills), a 1- and a 3-stage ring; none is faster at every size.
// q, k and v are read by strides with D contiguous
// and o is written by strides, so the (B, S, H, D) projection layout needs
// no copy. Fragment reads are conflict-free by layout, not by a swizzle:
// within an 8-wide k-step the fragment's k-slots t and t + 4 hold d = 2t
// and 2t + 1 (of Q and K alike, so the dot product is unchanged), so a
// lane reads four consecutive d of two k-steps with one 16-byte load from
// rows padded to 80 floats; P's k-slots follow S's accumulator layout
// (keys 2t, 2t + 1), so a lane reads V rows 2t and 2t + 1, conflict-free
// in rows padded to 68 floats. Each 3xTF32 pass runs over all the n-tiles
// before the next, so back-to-back MMAs are independent, and no MMA sits
// behind a branch. The softmax is branch-free: masked keys select NEG_INF,
// and a row with no live key yet subtracts 0, so its p is exactly 0. What
// holds the kernel above its bound is instruction issue: every warp
// splits every K and V value it reads (the same tile once in each of the 4
// warps), a third of the kernel's instructions, with few warps on each SM
// sub-partition to hide latency.
//
// Wide tensor-core entry (flash_attention_masked_wide_kernel), Dv = 64
// and D > 64 a multiple of 32: Eq. 2 at ViT-Tiny / Base / Large, (192 |
// 768 | 1024, 64), q (B, H, n, D) against the one shared key head x
// (B, 1, n, D). What bounds it on an H100: at q (4, 12, 197, 768) a call
// does 3.10 GFLOP, 18.8 us as three TF32 passes at 495 TFLOP/s, and moves
// 36.3 MB (10.8 us at 3.35 TB/s); the SIMT entry before it took 1.6 ms.
// The design: S = Q K^T runs on wgmma (m64n64k8 tf32, the only way to the
// card's TF32 rate) as 3xTF32, lo.hi + hi.lo + hi.hi a k-step, with the A
// fragments in registers; P V stays on the (64, 64) entry's mma.sync code
// (V is N-major, which TF32 wgmma does not take). K is x itself, shared
// by every query head and tile, so a first small kernel splits it into
// TF32 hi and lo once a call (3.3 us at Eq. 2's shape), straight into
// wgmma's K-major core-matrix B layout, with d permuted so that a warp
// takes its A values of two k-steps with one 16-byte load of Q. The main
// kernel's block is one warpgroup: 64 query rows of one head (kG heads of
// 64 / kG rows each when kG > 1) by 64-key steps; Q (f32) and the split
// K stream through a 3-stage cp.async ring in 32-float D-chunks, so
// shared memory does not grow with D (two blocks an SM), and a chunk
// costs one barrier. Each chunk's passes go into fresh accumulators
// added to S in f32: wgmma accumulates with truncation, and one
// accumulator over all of D = 768 read ~1.3e-5 off where this order
// reads ~3e-6. Splitting K inside each block instead repeated the same
// split in 48 blocks a batch and cost a second barrier a chunk (slower);
// the variants measured, the designs dropped and where the time goes:
// PERF.md (the kernel table and its findings),
// scripts/eq2_attention_variants.py.
//
// SIMT entry (flash_attention_masked_kernel), every (D, Dv) neither
// tensor-core entry takes: Dv != 64 (the GQA tests' (32, 48)), or D not a
// multiple of 32: the first design, kept unchanged. One block owns a
// 16-row query tile and walks 32-key tiles with synchronous loads, one
// warp per score row, f32 FMAs on the CUDA cores. Its Q and K tiles hold
// whole rows of D + 1 floats (odd strides: lane j reads K row j
// conflict-free), so its shared memory grows with D (162,304 bytes at
// (768, 64)); the wrapper raises where a block would not fit the card's
// opt-in limit.
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

// ---------------------------------------------------------------------------
// D = Dv = 64: 3xTF32 on the tensor cores, a cp.async K/V ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kD = 64;                 // head dim of q, k and v
constexpr int kBKV = 32;               // keys per tile; = KV_TILE
constexpr int kWarps = 4;              // a block's warps, 16 query rows each
constexpr int kBQ = 16 * kWarps;       // query rows per block
constexpr int kNT = 32 * kWarps;       // threads per block
constexpr int kLdQK = kD + 16;         // floats per Q / K row in shared memory
constexpr int kLdV = kD + 4;           // floats per V row
constexpr int kChunks = kD / 4;        // 16-byte chunks per row
constexpr int kQBytes = kBQ * kLdQK * 4;
constexpr int kKBytes = kBKV * kLdQK * 4;
constexpr int kVBytes = kBKV * kLdV * 4;
constexpr int kStageBytes = kKBytes + kVBytes + kBKV * 4;   // K, V, keep
constexpr int kSmem = kQBytes + 2 * kStageBytes;   // Q, a 2-stage ring
static_assert(kQBytes % 16 == 0 && kKBytes % 16 == 0 && kVBytes % 16 == 0,
              "cp.async needs 16-byte aligned destinations");

struct Strides {        // element strides of a (batch, head, row) walk
  long long b, h, s;
};

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
// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi), both rounded to nearest
// with ties away from zero, as cvt.rna.tf32.f32 rounds: half a TF32 ulp
// added to the magnitude, the low 13 bits cleared (two integer operations;
// inf stays inf); x - hi is exact in f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of N n-tiles, two f32 values each, split into hi / lo
template <int N>
__device__ __forceinline__ void split_b(const float2 (&b)[N],
                                        uint32_t (&bh)[N][2],
                                        uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n].x, bh[n][0], bl[n][0]);
    split(b[n].y, bh[n][1], bl[n][1]);
  }
}

// 3xTF32 over N independent n-tiles: c[n] += a.b[n] as lo.hi + hi.lo +
// hi.hi (the small terms first), each pass over every n-tile before the
// next, so that back-to-back MMAs never wait on one another's result. No
// MMA sits behind a branch: mma.sync under a divergent-looking branch gets
// a convergence region of its own, which serializes the MMAs.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bh[n][0], bh[n][1]);
}

// rows [row0, row0 + ROWS) of a (row stride rs) f32 matrix of kD columns
// into a tile with LD floats a row; rows >= limit are zero-filled
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* base,
                                          long long rs, int row0, int limit,
                                          int tid) {
  static_assert(ROWS * kChunks % kNT == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kNT; ++j) {
    const int i = tid + j * kNT;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async16(dst + (r * LD + c * 4) * 4,
               base + (in ? row0 + r : 0) * rs + c * 4, in ? 16 : 0);
  }
}

// S += Q K^T over one 16-wide slab of d, 3xTF32: xa / xb hold a lane's Q
// values d = 16p + 4 t4 + {0, 1, 2, 3} of rows g and g + 8, kr points at
// the same four of key row g (ld floats a key row; n-tile n's row g is
// kr + n * 8 * ld). k-step 2p takes the first two (k-slots t4, t4 + 4),
// k-step 2p + 1 the last two, of Q and K alike, so the dot product is
// unchanged and a lane reads each row's four with one 16-byte load.
__device__ __forceinline__ void qk_slab(float (&s)[kBKV / 8][4], float4 xa,
                                        float4 xb, const float* kr, int ld) {
  float2 k0[kBKV / 8], k1[kBKV / 8];   // k-steps 2p and 2p + 1
#pragma unroll
  for (int n = 0; n < kBKV / 8; ++n) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + n * 8 * ld);
    k0[n] = make_float2(kv.x, kv.y);
    k1[n] = make_float2(kv.z, kv.w);
  }
  uint32_t qh[4], ql[4], bh[kBKV / 8][2], bl[kBKV / 8][2];
  split(xa.x, qh[0], ql[0]);
  split(xb.x, qh[1], ql[1]);
  split(xa.y, qh[2], ql[2]);
  split(xb.y, qh[3], ql[3]);
  split_b(k0, bh, bl);
  mma3(s, qh, ql, bh, bl);
  split(xa.z, qh[0], ql[0]);
  split(xb.z, qh[1], ql[1]);
  split(xa.w, qh[2], ql[2]);
  split(xb.w, qh[3], ql[3]);
  split_b(k1, bh, bl);
  mma3(s, qh, ql, bh, bl);
}

// The online-softmax update of a warp's 16-row x kBKV-key score tile and
// O += P V, shared by both tensor-core entries: s[n][e] is key n * 8 + 2 t4
// + (e & 1) of row g (e < 2) or g + 8 (the accumulator layout), keep the
// tile's keep flags, Vs its V rows (kLdV floats apart, zero past Skv); P V
// takes the tile's first nn 8-key steps.
__device__ __forceinline__ void softmax_pv(float (&s)[kBKV / 8][4],
                                           float (&o)[kD / 8][4], float& m_a,
                                           float& m_b, float& l_a, float& l_b,
                                           const float* keep, const float* Vs,
                                           int nn, int g, int t4) {
  // mask, the rows' maxima (a row's values sit in one quad)
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int n = 0; n < kBKV / 8; ++n) {
    const float2 kp2 = *reinterpret_cast<const float2*>(
        keep + n * 8 + 2 * t4);
    s[n][0] = kp2.x > 0.f ? s[n][0] : kNegInf;
    s[n][1] = kp2.y > 0.f ? s[n][1] : kNegInf;
    s[n][2] = kp2.x > 0.f ? s[n][2] : kNegInf;
    s[n][3] = kp2.y > 0.f ? s[n][3] : kNegInf;
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
  // no live key yet subtracts 0 instead, so its masked keys give 0 too.
  // No branch per element: the exps of a row overlap.
  const float ms_a = mn_a == kNegInf ? 0.f : mn_a;
  const float ms_b = mn_b == kNegInf ? 0.f : mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < kBKV / 8; ++n) {
    s[n][0] = expf(s[n][0] - ms_a);
    s[n][1] = expf(s[n][1] - ms_a);
    s[n][2] = expf(s[n][2] - ms_b);
    s[n][3] = expf(s[n][3] - ms_b);
    sum_a += s[n][0] + s[n][1];
    sum_b += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
  }
  m_a = mn_a;
  m_b = mn_b;
  l_a = l_a * al_a + sum_a;
  l_b = l_b * al_b + sum_b;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    o[n][0] *= al_a; o[n][1] *= al_a;
    o[n][2] *= al_b; o[n][3] *= al_b;
  }
  // O += P V: k-step kk is n-tile kk of S, its k-slots t4 and t4 + 4
  // keys kk * 8 + 2 t4 and + 1, straight from the accumulators
#pragma unroll
  for (int kk = 0; kk < kBKV / 8; ++kk) {
    if (kk < nn) {
      uint32_t ph[4], pl[4], bh[kD / 8][2], bl[kD / 8][2];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
      const float* v0 = Vs + (kk * 8 + 2 * t4) * kLdV + g;
      float2 vb[kD / 8];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        vb[n] = make_float2(v0[n * 8], v0[kLdV + n * 8]);
      split_b(vb, bh, bl);
      mma3(o, ph, pl, bh, bl);
    }
  }
}

// a warp's 16 rows from row0 on, o / max(l, 1e-30), into rows below Sq
// of op (row stride rs)
__device__ __forceinline__ void store_rows(float* op, long long rs, int row0,
                                           int Sq, const float (&o)[kD / 8][4],
                                           float l_a, float l_b, int g,
                                           int t4) {
  const int row_a = row0 + g, row_b = row_a + 8;
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (row_a < Sq)
      *reinterpret_cast<float2*>(op + row_a * rs + c) =
          make_float2(o[n][0] / d_a, o[n][1] / d_a);
    if (row_b < Sq)
      *reinterpret_cast<float2*>(op + row_b * rs + c) =
          make_float2(o[n][2] / d_b, o[n][3] / d_b);
  }
}

__global__ void __launch_bounds__(kNT, 2)
flash_attention_masked_tc_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ mask,
                                 const int* __restrict__ nlive,
                                 float* __restrict__ out, Strides qs,
                                 Strides ks, Strides vs, Strides os, int H,
                                 int Hk, int Hv, int Sq, int Skv, int nkv,
                                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sKV = sQ + kQBytes;       // stage s at + s * kStageBytes
  const float* fsmem = reinterpret_cast<const float*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hk), hv = h / (H / Hv);
  const int q0 = blockIdx.x * kBQ;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hv * vs.h;
  const float* mrow = mask + (size_t)b * nkv * kBKV;   // zero-padded row
  const int* nl = nlive + b * nkv;

  // the K/V tile, keep flags included, into stage st
  auto load_tile = [&](int kt, int st) {
    const uint32_t dst = sKV + st * kStageBytes;
    const int j0 = kt * kBKV;
    load_rows<kBKV, kLdQK>(dst, kp, ks.s, j0, Skv, tid);
    load_rows<kBKV, kLdV>(dst + kKBytes, vp, vs.s, j0, Skv, tid);
    if (tid < kBKV / 4)
      cp_async16(dst + kKBytes + kVBytes + tid * 16, mrow + j0 + tid * 4, 16);
  };
  auto next_live = [&](int kt) {
    while (kt < nkv && nl[kt] == 0) ++kt;
    return kt;
  };

  int kt = next_live(0);
  if (kt < nkv) {                          // else every key is pruned: o = 0
    load_rows<kBQ, kLdQK>(sQ, qp, qs.s, q0, Sq, tid);
    load_tile(kt, 0);
  }
  cp_async_commit();

  const int w0 = q0 + warp * 16;           // the warp's first row
  const bool warp_live = w0 < Sq;
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int st = 0, first = 1; kt < nkv; st ^= 1, first = 0) {
    const int kn = next_live(kt + 1);
    if (kn < nkv) load_tile(kn, st ^ 1);   // the next live tile in flight
    cp_async_commit();
    cp_async_wait<1>();                    // this tile (and Q) have landed
    __syncthreads();

    if (first && warp_live) {              // the warp's 16 rows of Q *= scale
      float* qw = reinterpret_cast<float*>(smem) + warp * 16 * kLdQK;
#pragma unroll
      for (int i = lane; i < 16 * kChunks; i += 32) {
        float4* x = reinterpret_cast<float4*>(qw + (i / kChunks) * kLdQK +
                                              (i % kChunks) * 4);
        float4 y = *x;
        y.x = __fmul_rn(y.x, scale);
        y.y = __fmul_rn(y.y, scale);
        y.z = __fmul_rn(y.z, scale);
        y.w = __fmul_rn(y.w, scale);
        *x = y;
      }
      __syncwarp();
    }

    if (warp_live) {
      const float* Ks = fsmem + (kQBytes + st * kStageBytes) / 4;
      const float* Vs = Ks + kKBytes / 4;
      const float* keep = Vs + kVBytes / 4;
      // P V's 8-key steps that hold a key below Skv (past it K and V are
      // zero-filled and p is 0: those steps are skipped, one branch a
      // step; S takes every n-tile)
      const int nn = min(kBKV / 8, (Skv - kt * kBKV + 7) / 8);

      // S = (Q * scale) K^T: n-tiles of 8 keys, 16 d a step. Q's A
      // fragments are split again each tile (32 values a lane) rather
      // than held in 64 registers over the walk.
      float s[kBKV / 8][4];
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int p = 0; p < kD / 16; ++p) {
        const float* qr = fsmem + (warp * 16 + g) * kLdQK + 16 * p + 4 * t4;
        qk_slab(s, *reinterpret_cast<const float4*>(qr),
                *reinterpret_cast<const float4*>(qr + 8 * kLdQK),
                Ks + g * kLdQK + 16 * p + 4 * t4, kLdQK);
      }
      softmax_pv(s, o, m_a, m_b, l_a, l_b, keep, Vs, nn, g, t4);
    }
    __syncthreads();                       // this stage is free to refill
    kt = kn;
  }

  if (warp_live)
    store_rows(out + b * os.b + h * os.h, os.s, w0, Sq, o, l_a, l_b, g, t4);
}

int launch(const float* q, const float* k, const float* v, const float* mask,
           const int* nlive, float* out, Strides qs, Strides ks, Strides vs,
           Strides os, int B, int H, int Hk, int Hv, int Sq, int Skv, int nkv,
           float scale, cudaStream_t stream) {
  // set once: a CUDA runtime call on every launch would add host time
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_masked_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_masked_tc_kernel<<<grid, kNT, kSmem, stream>>>(
      q, k, v, mask, nlive, out, qs, ks, vs, os, H, Hk, Hv, Sq, Skv, nkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Dv = 64, D > 64 a multiple of kDC: 3xTF32 on the tensor cores, Q and K
// streamed in D-chunks through a cp.async ring
// ---------------------------------------------------------------------------
namespace wide {

using tc::Strides;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;

constexpr int kG = 1;                  // query heads a block, one key head
constexpr int kDC = 32;                // D-chunk: floats of a row a stage holds
constexpr int kStages = 3;             // ring depth
constexpr int kWarps = 4;              // one warpgroup; warp w: 16 query rows
constexpr int kNT = 32 * kWarps;
constexpr int kWPH = kWarps / kG;      // warps a head
constexpr int kRows = 16 * kWPH;       // query rows a head a block
constexpr int kTile = tc::kBKV;        // keys a KV tile; = KV_TILE
constexpr int kKeys = 2 * kTile;       // keys a step: S is 64 x 64 a block
constexpr int kCh = kDC / 4;           // 16-byte chunks a row of a stage
constexpr int kQRows = 16 * kWarps;
constexpr int kQBytes = kQRows * kDC * 4;
constexpr int kKBytes = kKeys * kDC * 4;
constexpr int kSplitUnits = 2 * kKBytes / 16;        // K's hi + lo a chunk
constexpr int kStageBytes = kQBytes + 2 * kKBytes;   // Q f32; K hi, K lo
constexpr int kKStep = kKeys * 8 * 4;                // a k-step of B: 2 KB
constexpr int kVBytes = kKeys * tc::kLdV * 4;        // one head's V rows
constexpr int kVOff = kStages * kStageBytes;         // kG heads' V, then keep
constexpr int kSmem = kVOff + kG * kVBytes + kKeys * 4;
static_assert(kWarps == 4 && kQRows == kKeys, "one warpgroup, 64 x 64");
static_assert(kWarps % kG == 0, "whole warps a head");
static_assert(kCh == 8, "a row of a stage is 8 chunks (the swizzle)");
static_assert((64 + kDC) / kDC >= kStages,
              "every D > 64 walks at least kStages chunks a step");
static_assert(2 * (kSmem + 1024) <= 232448, "two blocks an SM");

// Q's stage rows are kDC floats, unpadded; 16-byte chunk c of row r sits
// at chunk c ^ 4 (r & 1), so that the fragment loads of rows g and g + 1
// (one quarter-warp) fall in different banks.
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 1) << 2); }

// wgmma's shared-memory descriptor of a K-major tile in 8-row x 16-byte
// core matrices, no swizzle: the next core matrix along k 128 bytes on,
// along n 256 bytes on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 64 f32 over the warpgroup; each warp's 16 rows as mma.sync's
// accumulators of 8 n-tiles) += a (64 x 8 tf32, this warp's m16n8k8 A
// fragment) . b^T (64 x 8 tf32 in shared memory); acc 0 overwrites d
__device__ __forceinline__ void wgmma(float (&d)[kKeys / 8][4],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// K's split, once a call: k (B, Hk, Skv, D) -> kp, for each (batch, key
// head, 64-key step j, chunk c) 16 KB: hi = tf32(x), then lo = tf32(x -
// hi), each as 4 k-step tiles of wgmma's K-major B layout without
// swizzle (8-row x 16-byte core matrices, the next along k 128 bytes on,
// along the keys 256 bytes on). Within k-step kk = 2p + h, key n's k-slot
// t (t < 4) holds d = 16p + 4t + 2h and slot t + 4 holds d + 1, so that
// A's k-slots t4 and t4 + 4 take the same d and a lane reads its A values
// of two k-steps with one 16-byte load. Keys past Skv are zeros. Every
// block of the main kernel reads its K from here: the split is not
// repeated for each query tile and head.
__global__ void __launch_bounds__(kNT)
flash_attention_masked_wide_split_kernel(const float* __restrict__ k,
                                         Strides ks, float* __restrict__ kp,
                                         int Hk, int Skv, int D) {
  const int nch = D / kDC, j = blockIdx.x / nch, c = blockIdx.x % nch;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
  const int tid = threadIdx.x, r0 = tid / kCh, c0 = tid % kCh;
  // this thread's d = 32 c + 4 c0 .. + 3 (p = c0 / 4, t = c0 % 4) of keys
  // r0 + 16 i: key n sits in core matrix (n / 8, slot / 4), row n % 8,
  // element slot % 4
  float* hi = kp + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                       (2 * kKBytes / 4) +
              (c0 / 4) * 2 * kKStep / 4 + (r0 / 8) * 64 + (r0 % 8) * 4 +
              c0 % 4;
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i) {
    const int n = j * kKeys + r0 + 16 * i;
    const float4 x = n < Skv ? *reinterpret_cast<const float4*>(
                                   k + b * ks.b + hk * ks.h + n * ks.s +
                                   c * kDC + c0 * 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    float* at = hi + i * 128;              // keys r0 + 16 i: 2 core rows on
    uint32_t h, l;
    tc::split(x.x, h, l);
    at[0] = __uint_as_float(h);
    at[kKBytes / 4] = __uint_as_float(l);
    tc::split(x.y, h, l);
    at[32] = __uint_as_float(h);
    at[32 + kKBytes / 4] = __uint_as_float(l);
    tc::split(x.z, h, l);
    at[kKStep / 4] = __uint_as_float(h);
    at[kKStep / 4 + kKBytes / 4] = __uint_as_float(l);
    tc::split(x.w, h, l);
    at[kKStep / 4 + 32] = __uint_as_float(h);
    at[kKStep / 4 + 32 + kKBytes / 4] = __uint_as_float(l);
  }
}

__global__ void __launch_bounds__(kNT, 2)
flash_attention_masked_wide_kernel(const float* __restrict__ q,
                                   const float* __restrict__ v,
                                   const float* __restrict__ mask,
                                   const int* __restrict__ nlive,
                                   const float* __restrict__ kp,
                                   float* __restrict__ out, Strides qs,
                                   Strides vs, Strides os, int H, int Hk,
                                   int Hv, int Sq, int Skv, int D, int nkv,
                                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = tc::smem_addr(smem);
  float* fsmem = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int hpk = H / Hk;                  // query heads a key head
  const int ngrp = (hpk + kG - 1) / kG;    // head groups a key head
  const int b = blockIdx.y / (Hk * ngrp);
  const int hk = blockIdx.y / ngrp % Hk;
  const int j0 = blockIdx.y % ngrp * kG;   // the group's first head in hk's
  const int q0 = blockIdx.x * kRows;
  const int nch = D / kDC;                 // chunks a step
  const int nst = (nkv + 1) / 2;           // 64-key steps
  const float* mrow = mask + (size_t)b * nkv * kTile;  // zero-padded row
  const int* nl = nlive + b * nkv;
  auto head_live = [&](int w) { return j0 + w / kWPH < hpk; };
  auto tile_live = [&](int t) { return t < nkv && nl[t] != 0; };
  auto next_live = [&](int j) {            // the next step with a live key
    while (j < nst && !tile_live(2 * j) && !tile_live(2 * j + 1)) ++j;
    return j;
  };

  // What this thread copies, fixed for the whole walk: 16-byte chunk c0
  // of rows r0 + 16 i of the stage's Q chunk (rows 16 i.. of warp i, of
  // its head), and units tid + 128 i of the (step, chunk)'s split K
  constexpr int kLoads = kQRows * kCh / kNT;   // Q (and K) chunks a thread
  constexpr int kRowStep = kNT / kCh;
  static_assert(kRowStep == 16, "row r0 + 16 i");
  const int r0 = tid / kCh, c0 = tid % kCh;
  const float* qsrc[kLoads];
  bool qin[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int row = q0 + i % kWPH * 16 + r0;
    qin[i] = row < Sq && head_live(i);
    qsrc[i] = qin[i] ? q + b * qs.b + (hk * hpk + j0 + i / kWPH) * qs.h +
                           row * qs.s + c0 * 4
                     : q;
  }
  const float* ksrc = kp + (size_t)(b * Hk + hk) * nst * nch * kSplitUnits * 4 +
                      tid * 4;
  const uint32_t qdst = (r0 * kCh + swz(r0, c0)) * 16;  // + i * 16 rows

  // The producer walks the live steps' (64 keys, chunk) pairs kStages - 1
  // ahead of the consumer. A pair loads the 64 query rows' chunk and the
  // 64 keys' split chunk; chunk kStages - 1 of a step also loads its V
  // rows of the kG heads and its keep flags into the one V buffer, which
  // the step before released by then, and they land before the step's
  // last chunk. Q rows past Sq or of heads past the key head's, V rows
  // past Skv and keys past the padded mask are zero-filled (K's split
  // holds zeros past Skv).
  int pj = next_live(0), pc = 0;
  auto issue = [&](int st) {
    if (pj >= nst) return;
    const uint32_t dst = s0 + st * kStageBytes;
    const int d0 = pc * kDC, k0 = pj * kKeys;
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      cp_async16(dst + qdst + i * 16 * kDC * 4,
                 qsrc[i] + (qin[i] ? d0 : 0), qin[i] ? 16 : 0);
    const float* kx = ksrc + (size_t)(pj * nch + pc) * kSplitUnits * 4;
#pragma unroll
    for (int i = 0; i < kSplitUnits / kNT; ++i)
      cp_async16(dst + kQBytes + (tid + i * kNT) * 16, kx + i * kNT * 4, 16);
    if (pc == kStages - 1) {
      constexpr int kVCh = tc::kD / 4;     // 16-byte chunks a V row
#pragma unroll
      for (int i = 0; i < kG * kKeys * kVCh / kNT; ++i) {
        const int e = tid + i * kNT;
        const int hg = e / (kKeys * kVCh), r = e / kVCh % kKeys, c = e % kVCh;
        const bool in = k0 + r < Skv && j0 + hg < hpk;
        const int hv = (hk * hpk + j0 + hg) / (H / Hv);
        cp_async16(s0 + kVOff + hg * kVBytes + (r * tc::kLdV + c * 4) * 4,
                   in ? v + b * vs.b + hv * vs.h + (k0 + r) * vs.s + c * 4
                      : v,
                   in ? 16 : 0);
      }
      if (tid < kKeys / 4) {
        const bool in = k0 + tid * 4 < nkv * kTile;
        cp_async16(s0 + kVOff + kG * kVBytes + tid * 16,
                   in ? mrow + k0 + tid * 4 : mask, in ? 16 : 0);
      }
    }
    if (++pc == nch) {
      pc = 0;
      pj = next_live(pj + 1);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    issue(st);
    cp_async_commit();
  }

  const int w0 = q0 + warp % kWPH * 16;    // the warp's first row
  const bool warp_live = w0 < Sq && head_live(warp);
  const float* Vs = fsmem + kVOff / 4 + warp / kWPH * kVBytes / 4;
  const float* keep = fsmem + (kVOff + kG * kVBytes) / 4;
  const float* qfrag = fsmem + (warp * 16 + g) * kDC;   // + stage offset
  float o[tc::kD / 8][4], s[kKeys / 8][4];
#pragma unroll
  for (int n = 0; n < tc::kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  int st = 0;
  for (int j = next_live(0); j < nst; j = next_live(j + 1)) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<kStages - 2>();        // pair (j, c) has landed
      // (the async proxy reads what the copies wrote)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                     // and the last chunk's wgmma ran
      issue(st == 0 ? kStages - 1 : st - 1);
      cp_async_commit();

      // this warp's A fragments of the chunk's 4 k-steps, (Q * scale)
      // split in f32, as the TPU kernel scales it
      uint32_t qh[kDC / 8][4], ql[kDC / 8][4];
#pragma unroll
      for (int p = 0; p < kDC / 16; ++p) {
        const float* qr = qfrag + st * kStageBytes / 4 + swz(g, 4 * p + t4) * 4;
        float4 xa = *reinterpret_cast<const float4*>(qr);
        float4 xb = *reinterpret_cast<const float4*>(qr + 8 * kDC);
        xa.x = __fmul_rn(xa.x, scale); xa.y = __fmul_rn(xa.y, scale);
        xa.z = __fmul_rn(xa.z, scale); xa.w = __fmul_rn(xa.w, scale);
        xb.x = __fmul_rn(xb.x, scale); xb.y = __fmul_rn(xb.y, scale);
        xb.z = __fmul_rn(xb.z, scale); xb.w = __fmul_rn(xb.w, scale);
        tc::split(xa.x, qh[2 * p][0], ql[2 * p][0]);
        tc::split(xb.x, qh[2 * p][1], ql[2 * p][1]);
        tc::split(xa.y, qh[2 * p][2], ql[2 * p][2]);
        tc::split(xb.y, qh[2 * p][3], ql[2 * p][3]);
        tc::split(xa.z, qh[2 * p + 1][0], ql[2 * p + 1][0]);
        tc::split(xb.z, qh[2 * p + 1][1], ql[2 * p + 1][1]);
        tc::split(xa.w, qh[2 * p + 1][2], ql[2 * p + 1][2]);
        tc::split(xb.w, qh[2 * p + 1][3], ql[2 * p + 1][3]);
      }
      const uint32_t bhi = s0 + st * kStageBytes + kQBytes, blo = bhi + kKBytes;

      // S += (Q * scale) K^T over the chunk, 3xTF32 on wgmma (lo.hi +
      // hi.lo + hi.hi a k-step). The chunk's passes go into fresh
      // accumulators (the first wgmma overwrites them), added to S in f32
      // once the chunk is done: a tensor-core accumulator then takes 3 kDC
      // / 8 products, not 3 D / 8 (it adds them with truncation: one
      // accumulator over D = 768 read ~1.3e-5 off).
      float sc[kKeys / 8][4];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kDC / 8; ++kk) {
        wgmma(sc, ql[kk], b_desc(bhi + kk * kKStep), kk > 0);
        wgmma(sc, qh[kk], b_desc(blo + kk * kKStep), 1);
        wgmma(sc, qh[kk], b_desc(bhi + kk * kKStep), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the wgmma wrote sc behind the compiler's back: no read of it
          // may move above the wait
          asm volatile("" : "+f"(sc[n][e])::"memory");
          s[n][e] += sc[n][e];
        }
      st = st + 1 == kStages ? 0 : st + 1;
    }
    if (warp_live) {
      // the step's scores are whole: the online softmax and P V of each
      // live 32-key tile in turn (V and the keep flags landed with chunk
      // kStages - 1 and stay until the next step's)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kt = 2 * j + t;
        if (tile_live(kt))
          tc::softmax_pv(*reinterpret_cast<float(*)[kTile / 8][4]>(
                             &s[t * kTile / 8][0]),
                         o, m_a, m_b, l_a, l_b, keep + t * kTile,
                         Vs + t * kTile * tc::kLdV,
                         min(kTile / 8, (Skv - kt * kTile + 7) / 8), g, t4);
      }
    }
  }

  if (warp_live)
    tc::store_rows(out + b * os.b + (hk * hpk + j0 + warp / kWPH) * os.h,
                   os.s, w0, Sq, o, l_a, l_b, g, t4);
}

// kp: split_floats(B, Hk, nkv, D) floats of scratch for K's split
int launch(const float* q, const float* k, const float* v, const float* mask,
           const int* nlive, float* kp, float* out, Strides qs, Strides ks,
           Strides vs, Strides os, int B, int H, int Hk, int Hv, int Sq,
           int Skv, int D, int nkv, float scale, cudaStream_t stream) {
  // set once, on the first call (a warm start makes it eagerly, before any
  // CUDA graph capture): the block's shared memory does not depend on D
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_masked_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (D <= 64 || D % kDC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nst = (nkv + 1) / 2;
  flash_attention_masked_wide_split_kernel<<<dim3(nst * (D / kDC), B * Hk),
                                             kNT, 0, stream>>>(k, ks, kp, Hk,
                                                               Skv, D);
  const int ngrp = (H / Hk + kG - 1) / kG;
  const dim3 grid((Sq + kRows - 1) / kRows, B * Hk * ngrp);
  flash_attention_masked_wide_kernel<<<grid, kNT, kSmem, stream>>>(
      q, v, mask, nlive, kp, out, qs, vs, os, H, Hk, Hv, Sq, Skv, D, nkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

}  // namespace

// shared memory of one SIMT block at (D, Dv); the wrapper holds it against
// max_dynamic_smem before a launch
extern "C" int flash_attention_masked_smem(int D, int Dv) {
  return static_cast<int>(smem_bytes(D, Dv));
}

// the shared memory a block may opt into on card `device` (232,448 bytes
// on an H100), or minus the error
extern "C" int max_dynamic_smem(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

extern "C" int flash_attention_masked_f32(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          const void* nlive, void* out, int B,
                                          int H, int Hk, int Hv, int Sq,
                                          int Skv, int D, int Dv, int nkv,
                                          float scale, void* stream) {
  // the dynamic shared-memory ceiling is raised only when a larger block
  // comes (Eq. 2's (768, 64) takes 162,304 bytes), so the runtime call
  // runs on the first such launch, which a warm start makes eagerly, and
  // never inside a CUDA graph capture that follows it
  static size_t raised = 48 * 1024;
  const size_t smem = smem_bytes(D, Dv);
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_masked_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = smem;
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

// D = Dv = 64; strides: 12 element strides, (batch, head, row) for q, k, v
// and out in turn, D contiguous, every pointer and stride 16-byte aligned
// (the wrapper checks both); mask (B, nkv * 64) f32 zero-padded past Skv
extern "C" int flash_attention_masked_tc_f32(
    const void* q, const void* k, const void* v, const void* mask,
    const void* nlive, void* out, const long long* strides, int B, int H,
    int Hk, int Hv, int Sq, int Skv, int nkv, float scale, void* stream) {
  return tc::launch(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(mask),
                    static_cast<const int*>(nlive), static_cast<float*>(out),
                    tc::at(strides, 0), tc::at(strides, 1), tc::at(strides, 2),
                    tc::at(strides, 3), B, H, Hk, Hv, Sq, Skv, nkv, scale,
                    static_cast<cudaStream_t>(stream));
}

// Dv = 64, D > 64 a multiple of wide::kDC; strides and mask as the D = 64
// entry (16-byte aligned pointers and strides, the wrapper checks them);
// kscratch: (B Hk ceil(nkv / 2) D / 32) x 4096 f32 for K's split
extern "C" int flash_attention_masked_wide_f32(
    const void* q, const void* k, const void* v, const void* mask,
    const void* nlive, void* out, const long long* strides, void* kscratch,
    int B, int H, int Hk, int Hv, int Sq, int Skv, int D, int nkv,
    float scale, void* stream) {
  return wide::launch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const int*>(nlive), static_cast<float*>(kscratch),
      static_cast<float*>(out),
      tc::at(strides, 0), tc::at(strides, 1), tc::at(strides, 2),
      tc::at(strides, 3), B, H, Hk, Hv, Sq, Skv, D, nkv, scale,
      static_cast<cudaStream_t>(stream));
}
