// Device-noise draws of the calibrated MR noise model for Hopper: JAX's
// threefry2x32 (partitionable layout) and its uniform / normal transforms,
// as the reference draws them with jax.random, one thread an element.
//
// Replaces no TPU kernel: the reference draws these samples with jax.random
// outside any Pallas kernel (src/repro/core/noise.py::transmission_error,
// ::readout_noise, src/repro/kernels/ops.py::photonic_matmul_prequant_noisy).
// On the card each draw would otherwise be ~170 elementwise PyTorch launches
// (20 rounds of add / rotate / xor on masked int64), and a noisy flush makes
// a few hundred draws.
//
// Entries (kernels/noise_draw.py binds them):
//   noise_transmission_{s8,f32}: out[i] = f32(w[i]) * M[i] over a (K, N)
//     weight, M the drifted-branch transmission multiplier
//       M = (1 + (2u - 1) floor) * g(drift + sigma_w n_w) * (1 + sigma_f n_f)
//     u = uniform(kc), n_w = normal(fold_in(kc, WANDER)), n_f =
//     normal(fpv_key), g(d) = delta^2 / (d^2 + delta^2). One multiply by the
//     codes, the reference's own rounding, so the fused product is bitwise
//     the unfused one.
//   noise_readout_shot: y[i] *= 1 + sigma_s n_s[offset + i] in place,
//     n_s = normal(fold_in(kc, SHOT)) over the flat index of a draw whose
//     elements [offset, offset + n) y holds (a rank's rows of a flush split
//     along its batch: the draw GSPMD partitions; offset 0 unsplit).
//   noise_draw_bits: out[i] = random_bits(key)[i] under the draw key (folded
//     once more when fold != 0), for holding the generator bitwise.
//
// Keys: every block derives the call's draw key kc = fold_in(...fold_in(
// fold_in(key, frame), salt_1)..., counter) from the device state tensor
// (int32[4]: key words, frame, drift's f32 bits) that the host writes
// before each flush, so a CUDA graph replays the draws of the state written
// last; salts, counter and the FPV key (host-derived from the spec's seed)
// are launch arguments fixed per call site. The drifted crosstalk floor
// max_i sum_{j != i} phi(i, j) (a 32 x 32 reduction over the state's drift)
// is computed by each block's first warp while the second derives the keys.
//
// What bounds it on an H100: integer operations. One threefry2x32 is 20
// rounds of add, funnel-shift rotate and xor plus 6 key injections, ~75
// 32-bit integer ops; an element of the transmission entry runs 3 (u, n_w,
// n_f) and ~60 f32 ops (two erfinv polynomials, the Lorentzian, the
// products), while it moves 1-4 B in and 4 B out. At (3072, 768) that is
// ~0.53 G integer ops: 0.032 ms at the 16.7 Tops/s int32 rate (132 SMs x 64
// lanes x 1.98 GHz), against 11.8 MB = 0.0035 ms of HBM traffic. The design
// is the plain one that keeps the integer pipe busy: no shared memory past
// the block's keys and floor, a grid-stride loop over elements so the
// per-block key and floor work is amortised, funnel shifts for the rotates.
//
// Numerics, as XLA evaluates the reference on the CPU (kernels/ref.py and
// core/threefry.py are the plain versions): uniform's f * (hi - lo) + lo,
// the erfinv Horner steps and every a * b + c of the multiplier are fused
// multiply-adds (__fmaf_rn); every other product, sum and quotient is
// rounded on its own (__fmul_rn etc., so nvcc contracts nothing else);
// erfinv is XLA's f32 approximation (M. Giles), not CUDA's erfinvf.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSalts = 4;
constexpr int kMaxChannels = 32;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kWanderFold = 0x574E4401u;   // "WND"
constexpr uint32_t kShotFold = 0x53484F01u;     // "SHO"
// jax.random.normal's uniform lower bound nextafter(-1, 0) and sqrt(2), f32
constexpr float kNormalLo = -0.99999994f;
constexpr float kSqrt2 = 1.41421354f;

struct Key {
  uint32_t k0, k1;
};

struct Salts {
  uint32_t v[kMaxSalts];
  int n;
};

#define TF_ROUND(r)              \
  x0 += x1;                      \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}
#undef TF_ROUND

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry(k.k0, k.k1, x0, x1);
  return {x0, x1};
}

// jax.random.bits at flat index i: the xor of threefry(k, (i >> 32, i))
__device__ __forceinline__ uint32_t bits_at(Key k, int64_t i) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry(k.k0, k.k1, x0, x1);
  return x0 ^ x1;
}

// the top 23 bits as a float in [1, 2), minus 1: exact
__device__ __forceinline__ float unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// XLA's ErfInv32 (Giles): w = -log1p(-x^2); a degree-8 polynomial in
// w - 2.5 (w < 5) or sqrt(w) - 3, Horner steps as fused multiply-adds
__device__ __forceinline__ float erfinv_xla(float x) {
  constexpr float lt5[9] = {2.81022636e-08f,  3.43273939e-07f,
                            -3.5233877e-06f,  -4.39150654e-06f,
                            0.00021858087f,   -0.00125372503f,
                            -0.00417768164f,  0.246640727f,
                            1.50140941f};
  constexpr float ge5[9] = {-0.000200214257f, 0.000100950558f,
                            0.00134934322f,   -0.00367342844f,
                            0.00573950773f,   -0.0076224613f,
                            0.00943887047f,   1.00167406f,
                            2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  const float r = __fmul_rn(p, x);
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : r;
}

// jax.random.normal: sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)); the
// uniform's span 1 - nextafter(-1, 0) rounds to 2.0f
__device__ __forceinline__ float normal_at(Key k, int64_t i) {
  const float u = fmaxf(kNormalLo, __fmaf_rn(unit(bits_at(k, i)), 2.0f,
                                             kNormalLo));
  return __fmul_rn(kSqrt2, erfinv_xla(u));
}

__device__ __forceinline__ Key draw_key(const int32_t* state,
                                        const Salts& salts,
                                        uint32_t counter) {
  Key k{static_cast<uint32_t>(state[0]), static_cast<uint32_t>(state[1])};
  k = fold_in(k, static_cast<uint32_t>(state[2]));
  for (int s = 0; s < salts.n; ++s) k = fold_in(k, salts.v[s]);
  return fold_in(k, counter);
}

// max_i sum_j phi(i, j) of the drifted crosstalk matrix, on one warp:
// lane i sums its row in j order (core/noise.py::drifted_noise_floor)
__device__ float drifted_floor(float drift, float center, float spacing,
                               float two_q, int channels) {
  const int i = threadIdx.x & 31;
  const float half = 0.5f * static_cast<float>(channels - 1);
  float row = 0.0f;
  if (i < channels) {
    const float li = __fadd_rn(
        center, __fmul_rn(__fsub_rn(static_cast<float>(i), half), spacing));
    const float di = __fdiv_rn(li, two_q);
    const float d2 = __fmul_rn(di, di);
    const float shifted = __fadd_rn(li, drift);
    for (int j = 0; j < channels; ++j) {
      const float lj = __fadd_rn(
          center, __fmul_rn(__fsub_rn(static_cast<float>(j), half), spacing));
      const float diff = __fsub_rn(shifted, lj);
      float phi = __fdiv_rn(d2, __fadd_rn(__fmul_rn(diff, diff), d2));
      phi = __fmul_rn(phi, j == i ? 0.0f : 1.0f);
      row = __fadd_rn(row, phi);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, off));
  return row;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
noise_transmission_kernel(const T* __restrict__ w, float* __restrict__ out,
                          int64_t n, const int32_t* __restrict__ state,
                          Salts salts, uint32_t counter, uint32_t fpv0,
                          uint32_t fpv1, float fpv_sigma, float wander_sigma,
                          float delta2, float center, float spacing,
                          float two_q, int channels) {
  __shared__ Key s_kc, s_kw;
  __shared__ float s_floor, s_drift;
  if (threadIdx.x < 32) {
    const float drift = __int_as_float(state[3]);
    const float floor_ = drifted_floor(drift, center, spacing, two_q,
                                       channels);
    if (threadIdx.x == 0) {
      s_floor = floor_;
      s_drift = drift;
    }
  } else if (threadIdx.x == 32) {
    const Key kc = draw_key(state, salts, counter);
    s_kc = kc;
    s_kw = fold_in(kc, kWanderFold);
  }
  __syncthreads();
  const Key kc = s_kc, kw = s_kw, kf{fpv0, fpv1};
  const float floor_ = s_floor, drift = s_drift;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float u = unit(bits_at(kc, i));
    float m = __fmaf_rn(__fsub_rn(__fmul_rn(2.0f, u), 1.0f), floor_, 1.0f);
    float det = drift;
    if (wander_sigma > 0.0f)
      det = __fmaf_rn(normal_at(kw, i), wander_sigma, drift);
    m = __fmul_rn(m, __fdiv_rn(delta2, __fmaf_rn(det, det, delta2)));
    if (fpv_sigma > 0.0f)
      m = __fmul_rn(m, __fmaf_rn(normal_at(kf, i), fpv_sigma, 1.0f));
    out[i] = __fmul_rn(static_cast<float>(w[i]), m);
  }
}

__global__ void __launch_bounds__(kThreads)
noise_readout_shot_kernel(float* __restrict__ y, int64_t n, int64_t offset,
                          const int32_t* __restrict__ state, Salts salts,
                          uint32_t counter, float sigma) {
  __shared__ Key s_ks;
  if (threadIdx.x == 0)
    s_ks = fold_in(draw_key(state, salts, counter), kShotFold);
  __syncthreads();
  const Key ks = s_ks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride)
    y[i] = __fmul_rn(y[i],
                     __fmaf_rn(normal_at(ks, offset + i), sigma, 1.0f));
}

__global__ void __launch_bounds__(kThreads)
noise_draw_bits_kernel(uint32_t* __restrict__ out, int64_t n,
                       const int32_t* __restrict__ state, Salts salts,
                       uint32_t counter, uint32_t fold) {
  __shared__ Key s_k;
  if (threadIdx.x == 0) {
    Key k = draw_key(state, salts, counter);
    s_k = fold ? fold_in(k, fold) : k;
  }
  __syncthreads();
  const Key k = s_k;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = bits_at(k, i);
}

// blocks of a grid-stride launch over n elements: 4 elements a thread once
// the card is full (132 SMs x 8 blocks), one otherwise
unsigned grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8;
  const int64_t four = (n + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t blocks = want <= cap ? want : (four > cap ? four : cap);
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

Salts make_salts(const uint32_t* v, int n) {
  Salts s{};
  s.n = n;
  for (int i = 0; i < n && i < kMaxSalts; ++i) s.v[i] = v[i];
  return s;
}

template <typename T>
int launch_transmission(const void* w, void* out, long long n,
                        const void* state, const uint32_t* salts, int n_salts,
                        unsigned counter, unsigned fpv0, unsigned fpv1,
                        float fpv_sigma, float wander_sigma, float delta2,
                        float center, float spacing, float two_q,
                        int channels, void* stream) {
  if (n_salts > kMaxSalts || channels > kMaxChannels || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  noise_transmission_kernel<T><<<grid_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<float*>(out), n,
      static_cast<const int32_t*>(state), make_salts(salts, n_salts),
      counter, fpv0, fpv1, fpv_sigma, wander_sigma, delta2, center, spacing,
      two_q, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int noise_transmission_s8(
    const void* w, void* out, long long n, const void* state,
    const unsigned* salts, int n_salts, unsigned counter, unsigned fpv0,
    unsigned fpv1, float fpv_sigma, float wander_sigma, float delta2,
    float center, float spacing, float two_q, int channels, void* stream) {
  return launch_transmission<int8_t>(w, out, n, state, salts, n_salts,
                                     counter, fpv0, fpv1, fpv_sigma,
                                     wander_sigma, delta2, center, spacing,
                                     two_q, channels, stream);
}

extern "C" int noise_transmission_f32(
    const void* w, void* out, long long n, const void* state,
    const unsigned* salts, int n_salts, unsigned counter, unsigned fpv0,
    unsigned fpv1, float fpv_sigma, float wander_sigma, float delta2,
    float center, float spacing, float two_q, int channels, void* stream) {
  return launch_transmission<float>(w, out, n, state, salts, n_salts,
                                    counter, fpv0, fpv1, fpv_sigma,
                                    wander_sigma, delta2, center, spacing,
                                    two_q, channels, stream);
}

extern "C" int noise_readout_shot(void* y, long long n, long long offset,
                                  const void* state, const unsigned* salts,
                                  int n_salts, unsigned counter, float sigma,
                                  void* stream) {
  if (n_salts > kMaxSalts) return static_cast<int>(cudaErrorInvalidValue);
  noise_readout_shot_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(y), n, offset, static_cast<const int32_t*>(state),
      make_salts(salts, n_salts), counter, sigma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int noise_draw_bits(void* out, long long n, const void* state,
                               const unsigned* salts, int n_salts,
                               unsigned counter, unsigned fold,
                               void* stream) {
  if (n_salts > kMaxSalts) return static_cast<int>(cudaErrorInvalidValue);
  noise_draw_bits_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, static_cast<const int32_t*>(state),
      make_salts(salts, n_salts), counter, fold);
  return static_cast<int>(cudaGetLastError());
}
