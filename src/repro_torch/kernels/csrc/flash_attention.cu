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
// SIMT entry (flash_attention_masked_kernel), every other (D, Dv): Eq. 2's
// (768, 64) at ViT-Base (q (B, 12, n, 768) against the one shared key head
// x (B, 1, n, 768)), (1024, 64) at ViT-Large, GQA tests at (32, 48): the
// first design, kept unchanged. One block owns a 16-row query tile and
// walks 32-key tiles with synchronous loads, one warp per score row, f32
// FMAs on the CUDA cores. Its Q and K tiles hold whole rows of D + 1
// floats (odd strides: lane j reads K row j conflict-free), so its shared
// memory grows with D: 162,304 bytes at (768, 64), 211,456 at (1024, 64),
// one block an SM; the wrapper raises where a block would not fit the
// card's opt-in limit. At (768, 64) the call is bound by its f32 score
// FLOPs (2 n^2 D a head), which this entry runs one FMA chain a lane.
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
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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
    cp_async_wait_all_but_one();           // this tile (and Q) have landed
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

      // S = (Q * scale) K^T: n-tiles of 8 keys, one k-step at a time. Q's
      // A fragments are split again each tile (32 values a lane) rather
      // than held in 64 registers over the walk. d = 16p + 4t4 + {0, 1, 2,
      // 3} of rows g and g + 8: k-step 2p takes the first two (k-slots t4,
      // t4 + 4), k-step 2p + 1 the last two; K alike.
      float s[kBKV / 8][4];
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int p = 0; p < kD / 16; ++p) {
        const float* qr = fsmem + (warp * 16 + g) * kLdQK + 16 * p + 4 * t4;
        const float4 xa = *reinterpret_cast<const float4*>(qr);
        const float4 xb = *reinterpret_cast<const float4*>(qr + 8 * kLdQK);
        float2 k0[kBKV / 8], k1[kBKV / 8];   // k-steps 2p and 2p + 1
#pragma unroll
        for (int n = 0; n < kBKV / 8; ++n) {
          const float4 kv = *reinterpret_cast<const float4*>(
              Ks + (n * 8 + g) * kLdQK + 16 * p + 4 * t4);
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
      // mask, the rows' maxima (a row's values sit in one quad); s[n][e]
      // is key n * 8 + 2 t4 + (e & 1) of row g (e < 2) or g + 8
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
    __syncthreads();                       // this stage is free to refill
    kt = kn;
  }

  if (warp_live) {
    float* op = out + b * os.b + h * os.h;
    const int row_a = w0 + g, row_b = row_a + 8;
    const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (row_a < Sq)
        *reinterpret_cast<float2*>(op + row_a * os.s + c) =
            make_float2(o[n][0] / d_a, o[n][1] / d_a);
      if (row_b < Sq)
        *reinterpret_cast<float2*>(op + row_b * os.s + c) =
            make_float2(o[n][2] / d_b, o[n][3] / d_b);
    }
  }
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
