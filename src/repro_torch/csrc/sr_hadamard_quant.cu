// Fused randomized grouped-Hadamard + stochastic-rounding MXFP4 quantization
// (backward Stage 1 of Quartet's Algorithm 1).
//
// Replaces the Pallas TPU kernel repro/kernels/sr_hadamard_quant.py
// (_sr_hadamard_kernel and _e2m1_stochastic_round, entry
// sr_hadamard_quantize).  Per 32-element group along K:
//   xh    = prescale · (x ⊙ signs) · H32
//   scale = E8M0-ceil(max(absmax(xh) / 6, 2^-126))
//   codes = int8(2 · SR_E2M1(xh / scale, u)),  u = fastrng(seed, salt, m·K + k)
//
// Bound on H100: bytes.  It reads x once (4 or 2 B/element) and writes 1 B
// of code per element plus 4 B of scale per group; the arithmetic (~60
// operations per element, the hash included) is far below the card's ratio
// of operations to bytes.
//
// Design: the twin of hadamard_quant.cu.  One block owns a 32-row x
// 32-column tile (one group column).  The load walks whichever axis of x has
// unit stride, so a row-major operand and a transposed view (the dW
// operands xᵀ and dyᵀ) are both read coalesced and without a copy.  Each warp
// then quantizes whole groups, one element per lane: the Hadamard as 5
// __shfl_xor_sync butterfly stages, the absmax as a warp max.  The uniforms
// are not read from memory: each lane hashes (seed, salt, logical index) in
// registers with the murmur3 finalizer of repro_torch/core/fastrng.py, the
// index being row · K + col of the logical [M, K] operand (mod 2^32), not the
// memory offset.  All arithmetic uses the _rn intrinsics (never contracted
// into FMAs) and the exponents come from the bits, so the kernel is
// bit-exact with sr_hadamard_quantize_plain in
// repro_torch/kernels/sr_hadamard_quant.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// f32 entry of the normalized 32x32 Hadamard matrix, fl32(1/sqrt(32))
constexpr float kHadamardScale = 0.1767766922712326f;
constexpr float kMinScale = 1.17549435082228750797e-38f;  // 2^-126
// ceil(log2(1.m · 2^e) − 1e-6) = e + 1 exactly when the mantissa field m >= 6
constexpr int kCeilMantissa = 6;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// fastrng.uniform: top 24 bits of the hash, times 2^-24 (exact)
__device__ __forceinline__ float uniform(uint32_t index, uint32_t seed_salt) {
  uint32_t h = index * 2654435761u + seed_salt;
  h = fmix(fmix(h) + 0x9e3779b9u);
  return __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float exp2i(int e) { return __int_as_float((e + 127) << 23); }

// Unbiased SR of v (|v| <= 6·(1 + 5·2^-23)) onto the E2M1 grid, saturating
// at 6: step = 2^(floor(log2 max(|v|, 1)) − 1) from the exponent bits.
__device__ __forceinline__ float sr_e2m1(float v, float u) {
  const float a = fabsf(v);
  const int e = ((__float_as_int(fmaxf(a, 1.f)) >> 23) & 0xff) - 127;
  const float step = exp2i(e - 1);
  const float lo = __fmul_rn(floorf(__fdiv_rn(a, step)), step);
  const float p_up = __fdiv_rn(__fsub_rn(a, lo), step);
  const float q = fminf(u < p_up ? __fadd_rn(lo, step) : lo, 6.f);
  return copysignf(q, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sr_hadamard_kernel(
    const T* __restrict__ x, long long M, long long K, long long sm, long long sk,
    const float* __restrict__ signs, uint32_t seed_salt, float prescale,
    int8_t* __restrict__ codes, float* __restrict__ scales) {
  __shared__ float tile[kRows][kGroup + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long k0 = static_cast<long long>(blockIdx.y) * kGroup;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * kGroup; i += kThreads) {
    int r, c;
    if (sk == 1) {  // row-major: consecutive threads walk K
      r = i / kGroup;
      c = i % kGroup;
    } else {  // column-major (a transposed view): consecutive threads walk M
      c = i / kRows;
      r = i % kRows;
    }
    const long long m = m0 + r;
    tile[r][c] = m < M ? to_f32(x[m * sm + (k0 + c) * sk]) : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long groups = K / kGroup;
  const float sign = signs[k0 + lane];
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long m = m0 + r;
    if (m >= M) break;  // warp-uniform: rows only grow
    float v = __fmul_rn(tile[r][lane], sign);
#pragma unroll
    for (int h = 1; h < kGroup; h <<= 1) {
      const float o = __shfl_xor_sync(kFull, v, h);
      v = (lane & h) ? __fsub_rn(o, v) : __fadd_rn(v, o);
    }
    v = __fmul_rn(__fmul_rn(v, kHadamardScale), prescale);

    float amax = fabsf(v);
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, h));
    const float raw = fmaxf(__fdiv_rn(amax, 6.f), kMinScale);

    const int bits = __float_as_int(raw);
    int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kCeilMantissa ? 1 : 0);
    e = min(max(e, -126), 127);
    const float scale = exp2i(e);

    const long long o = m * K + k0 + lane;
    const float u = uniform(static_cast<uint32_t>(o), seed_salt);
    const float q = sr_e2m1(__fdiv_rn(v, scale), u);
    codes[o] = static_cast<int8_t>(rintf(__fmul_rn(q, 2.f)));
    if (lane == 0) scales[m * groups + blockIdx.y] = scale;
  }
}

}  // namespace

// x [M, K] with element strides (sm, sk), f32 (is_bf16 = 0) or bf16; signs
// f32 [K]; writes codes int8 [M, K] and scales f32 [M, K/32] (contiguous).
extern "C" int sr_hadamard_quantize(const void* x, int is_bf16, long long M, long long K,
                                    long long sm, long long sk, const void* signs,
                                    uint32_t seed, uint32_t salt, float prescale, void* codes,
                                    void* scales, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows),
                  static_cast<unsigned>(K / kGroup));
  // the hash's per-call constant, as fastrng.random_bits adds it (mod 2^32)
  const uint32_t seed_salt = seed * 2246822519u + salt * 3266489917u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  if (is_bf16) {
    sr_hadamard_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, sm, sk, sg, seed_salt, prescale,
        static_cast<int8_t*>(codes), static_cast<float*>(scales));
  } else {
    sr_hadamard_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), M, K, sm, sk, sg, seed_salt, prescale,
        static_cast<int8_t*>(codes), static_cast<float*>(scales));
  }
  return static_cast<int>(cudaGetLastError());
}
