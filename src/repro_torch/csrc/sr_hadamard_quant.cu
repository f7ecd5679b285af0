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
// Bound on H100: operations, with the bytes close behind.  It reads x once
// (2 or 4 B/element) and writes 1 B of code per element plus 4 B of scale
// per group.  Per element, the fewest operations of this exact form are 22
// on f32 (the sign, the five butterfly stages, the two prescalings, the
// absmax, the scaling, the uniform's conversion and scaling, the SR's nine,
// the code byte's add) and 22.75 on int32 (the index, two murmur3 fmix
// rounds of 8, the hash's add and shift, the SR's exponent mask,
// reciprocal and sign, 3 byte permutes a word); int32 runs at half the f32
// rate, so the int32 work takes longer than the bytes (B2_F32_OPS and
// B2_INT32_OPS in chip_smoke.py).  So the design spends no instruction that
// the arithmetic does not need: no shuffles, one division a group, the
// codes packed by byte permutes.
//
// Bit-exactness fixes the arithmetic order: every element goes through the
// plain version's _rn operations in its order (sr_hadamard_quantize_plain in
// repro_torch/kernels/sr_hadamard_quant.py): the sign, the butterfly stages
// h = 1 .. 16 (the element with bit h clear keeps a + b, the other a − b),
// the x fl32(1/sqrt(32)), the x prescale, the absmax, the one division
// amax / 6 a group and the E8M0-ceil from its bits.  The other divisions
// are all by powers of two and are multiplies by exact reciprocals built
// from the bits: v / scale as v · 2^-e (2^-127 as a subnormal), which rounds
// the same real number; a / step (step = 2^(E−1)) as the exact product x =
// a · 2^(1−E), and (a − lo) / step as x − floor(x), also exact.  No FMA
// contraction (the _rn intrinsics).  The uniforms are not read from memory: each
// element hashes (seed, salt, logical index) in registers with the murmur3
// finalizer of repro_torch/core/fastrng.py, the index being row · K + col
// of the logical [M, K] operand (mod 2^32), not the memory offset, so a
// transposed view draws the plain version's bits.
//
// Two bodies.
//
// The vector body (every call of the training path: dy row-major, and Wq,
// xqᵀ, dyᵀ with unit stride along M): one thread owns a whole 32-group and
// runs all of it in registers — the five butterfly stages unrolled at
// compile time, the absmax, the single division and the E8M0-ceil once per
// group, the hash and the SR per element, no shuffle (sr_hadamard_group).
// It runs in the walkers of group_quant.cuh: rows_kernel for row-major x
// (dy; 16-byte loads, consecutive threads on consecutive groups of a row),
// cols_kernel for unit stride along M (Wq, xqᵀ, dyᵀ; [32 k x 128 m] tiles
// staged in place through a two-stage cp.async ring, no transpose copy).
// Codes leave as 16-byte stores, paired across lanes so that each store
// instruction writes whole 32-byte sectors.
// Taken when x is 16-byte aligned with 16-byte aligned rows (row-major), or
// with M % 8 == 0 and 16-byte aligned columns (unit stride along M).
//
// sr_hadamard_kernel (other strides and alignments): one block owns a
// 32-row x 32-column tile (one group column), loaded through whichever axis
// has unit stride into shared memory; each warp quantizes whole groups, one
// element per lane, the Hadamard as 5 __shfl_xor_sync butterfly stages, the
// absmax as a warp max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_quant.cuh"

namespace {

using group_quant::kGroup;
using group_quant::to_f32;
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// f32 entry of the normalized 32x32 Hadamard matrix, fl32(1/sqrt(32))
constexpr float kHadamardScale = 0.1767766922712326f;
constexpr float kMinScale = 1.17549435082228750797e-38f;  // 2^-126
// ceil(log2(1.m · 2^e) − 1e-6) = e + 1 exactly when the mantissa field m >= 6
constexpr int kCeilMantissa = 6;
// fastrng's multiplier of the linear index
constexpr uint32_t kIndexMul = 2654435761u;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// fastrng.uniform from h = index · kIndexMul + seed_salt: the top 24 bits of
// the hash, times 2^-24 (exact)
__device__ __forceinline__ float uniform(uint32_t h) {
  h = fmix(fmix(h) + 0x9e3779b9u);
  return __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-08f);
}

// E8M0-ceil exponent of a group's scale from its absmax, in [-126, 127]
__device__ __forceinline__ int e8m0_ceil_exponent(float amax) {
  const float raw = fmaxf(__fdiv_rn(amax, 6.f), kMinScale);
  const int bits = __float_as_int(raw);
  const int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kCeilMantissa ? 1 : 0);
  return min(max(e, -126), 127);
}

// 2^-e for e in [-126, 127], exact (2^-127 is subnormal): v·2^-e is the
// correctly rounded v / 2^e
__device__ __forceinline__ float inv_exp2(int e) {
  return e < 127 ? __int_as_float((127 - e) << 23) : __int_as_float(0x00400000);
}

// The half-code 2·SR_E2M1(v, u) as an integer-valued float in [-12, 12]:
// unbiased SR of v (|v| <= 6·(1 + 5·2^-23)) onto the E2M1 grid, saturating
// at 6.  With step = 2^(E − 1), E = floor(log2 max(|v|, 1)) from the
// exponent field, x = |v| / step is the exact product |v|·2^(1−E) (the
// reciprocal from the same bits); lo = floor(x)·step, and p_up = (|v| −
// lo) / step = x − floor(x), exactly.  Then 2·min(r·step, 6) = min(r·2^E,
// 12) for r = floor(x) or floor(x) + 1, exact.  (An infinite v gives
// 2^(1−E) = 0 and NaN, which fminf takes to 12, the plain version's
// saturation.)
__device__ __forceinline__ float sr_half_code(float v, float u) {
  const uint32_t fb = __float_as_uint(fmaxf(fabsf(v), 1.f)) & 0x7f800000u;  // 2^E
  const float x = __fmul_rn(fabsf(v), __uint_as_float(0x7f800000u - fb));  // |v|·2^(1−E)
  const float f = floorf(x);
  const float r = u < __fsub_rn(x, f) ? __fadd_rn(f, 1.f) : f;
  return copysignf(fminf(__fmul_rn(r, __uint_as_float(fb)), 12.f), v);
}

// the low byte of an integer-valued float t in [-128, 127] (two's
// complement): t + 1.5·2^23 holds t in its low mantissa bits, exactly
__device__ __forceinline__ uint32_t low_byte(float t) {
  return __float_as_uint(__fadd_rn(t, 12582912.f));
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
    const int e = e8m0_ceil_exponent(amax);

    const long long o = m * K + k0 + lane;
    const float u = uniform(static_cast<uint32_t>(o) * kIndexMul + seed_salt);
    codes[o] = static_cast<int8_t>(static_cast<int>(sr_half_code(__fmul_rn(v, inv_exp2(e)), u)));
    if (lane == 0) scales[m * groups + blockIdx.y] = __int_as_float((e + 127) << 23);
  }
}

// v ⊙ the group's 32 signs (16-byte aligned f32), exact (±1)
__device__ __forceinline__ void apply_signs(float (&v)[kGroup], const float* __restrict__ sg) {
  const float4* s4 = reinterpret_cast<const float4*>(sg);
#pragma unroll
  for (int i = 0; i < kGroup / 4; ++i) {
    const float4 s = s4[i];
    v[4 * i] = __fmul_rn(v[4 * i], s.x);
    v[4 * i + 1] = __fmul_rn(v[4 * i + 1], s.y);
    v[4 * i + 2] = __fmul_rn(v[4 * i + 2], s.z);
    v[4 * i + 3] = __fmul_rn(v[4 * i + 3], s.w);
  }
}

// the vector bodies' group (group_quant.cuh), x's group in v on entry: the
// plain version's arithmetic in its order on one whole 32-group in
// registers; element i of group g of row m hashes h0 + i·kIndexMul, h0 =
// (m·K + 32g)·kIndexMul + seed_salt.  Returns the scale and the 32
// half-codes as words (w[0]).
struct sr_hadamard_group {
  static constexpr int kOuts = 1;
  uint8_t* out[kOuts];  // codes
  float* scales;
  const float* signs;  // [K], 16-byte aligned
  uint32_t seed_salt;
  float prescale;

  __device__ __forceinline__ float operator()(float (&v)[kGroup], long long m, long long g,
                                              long long K, uint32_t (&w)[kOuts][8]) const {
    apply_signs(v, signs + g * kGroup);
    group_quant::butterfly_stage<1>(v);
    group_quant::butterfly_stage<2>(v);
    group_quant::butterfly_stage<4>(v);
    group_quant::butterfly_stage<8>(v);
    group_quant::butterfly_stage<16>(v);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      v[i] = __fmul_rn(__fmul_rn(v[i], kHadamardScale), prescale);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const int e = e8m0_ceil_exponent(amax);
    const float inv = inv_exp2(e);
    const uint32_t h0 = static_cast<uint32_t>(m * K + g * kGroup) * kIndexMul + seed_salt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * j + k;
        b[k] = low_byte(sr_half_code(__fmul_rn(v[i], inv), uniform(h0 + i * kIndexMul)));
      }
      // bytes 0 of b[0..3] into one word, element 4j in the lowest byte
      w[0][j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                            0x5410);
    }
    return __int_as_float((e + 127) << 23);
  }
};

}  // namespace

// x [M, K] with element strides (sm, sk), f32 (is_bf16 = 0) or bf16; signs
// f32 [K]; writes codes int8 [M, K] and scales f32 [M, K/32] (contiguous,
// 16-byte aligned).  vector = 1 runs the vector body (x must satisfy
// group_quant::vector_ok and signs be 16-byte aligned, else
// cudaErrorInvalidValue), 0 the tile body.
extern "C" int sr_hadamard_quantize(const void* x, int is_bf16, long long M, long long K,
                                    long long sm, long long sk, const void* signs,
                                    uint32_t seed, uint32_t salt, float prescale, void* codes,
                                    void* scales, int vector, void* stream) {
  // the hash's per-call constant, as fastrng.random_bits adds it (mod 2^32)
  const uint32_t seed_salt = seed * 2246822519u + salt * 3266489917u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  if (vector) {
    if (!group_quant::vector_ok(x, is_bf16 ? 2 : 4, M, sm, sk) ||
        (reinterpret_cast<uintptr_t>(signs) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
    const sr_hadamard_group q = {{static_cast<uint8_t*>(codes)}, static_cast<float*>(scales), sg,
                                 seed_salt, prescale};
    return is_bf16 ? group_quant::launch<__nv_bfloat16>(x, M, K, sm, sk, q, s)
                   : group_quant::launch<float>(x, M, K, sm, sk, q, s);
  }
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows),
                  static_cast<unsigned>(K / kGroup));
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
