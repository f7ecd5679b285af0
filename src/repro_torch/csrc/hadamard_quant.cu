// Fused grouped-Hadamard + QuEST MXFP4 quantization (forward Stage 1).
//
// Replaces the Pallas TPU kernel repro/kernels/hadamard_quant.py
// (_hadamard_quest_kernel, entry hadamard_quest_quantize).  Per 32-element
// group along K: xh = x·H32; scale = E8M0-nearest(c*·rms(xh)/6);
// codes = int8(2·RTN_E2M1(clip(xh/scale, ±6))); mask = |xh/scale| <= 6.
//
// Bound on H100: bytes.  It reads x once (2 or 4 B/element) and writes
// 2 B/element (int8 code + bool mask) plus 4 B per group; the arithmetic is
// ~40 flops/element, far below the card's ratio of flops to bytes.
//
// Bit-exactness fixes the arithmetic order: every element goes through the
// plain version's _rn operations in its order (hadamard_quest_quantize_plain
// in repro_torch/kernels/hadamard_quant.py): the butterfly stages h = 1 ..
// 16, where the element with bit h clear keeps a + b and the other a − b;
// the x fl32(1/sqrt(32)); the squares summed as the halving sum folds them
// (v[i] + v[i+16] first, then +8, +4, +2, +1); the E8M0-nearest from the
// mantissa against sqrt(2); the division by the scale; the RTN.  No FMA
// contraction (the _rn intrinsics), and the E8M0/E2M1 roundings are
// integer/bit arithmetic.  Any mapping of elements to threads that keeps
// this order is bit-exact.  Both bodies divide by the power-of-two scale
// 2^e as a multiply by 2^-e built from the bits (exact, 2^-127 as a
// subnormal), which rounds the same real number, so it gives __fdiv_rn's
// bits; and both take the half-code 2·RTN(q) as rint(|q|·2/pw)·pw with the
// sign, pw the binade's power of two, each step exact.
//
// Two bodies.
//
// The vector body (every call of the serving, training and evaluation
// paths): one thread owns a whole 32-group and runs all of it in registers
// — the five butterfly stages, the halving sum, no shuffle
// (hadamard_quest_group).  It runs in the walkers of group_quant.cuh:
// rows_kernel for row-major x (activations; 16-byte loads, consecutive
// threads on consecutive groups of a row), cols_kernel for the transposed
// weight view Wᵀ (unit stride along M; [32 k x 128 m] tiles staged in
// place through a two-stage cp.async ring).  Codes and mask leave as
// 16-byte stores, paired across lanes so that each store instruction
// writes whole 32-byte sectors.
// Taken when x is 16-byte aligned with 16-byte aligned rows (row-major), or
// with M % 8 == 0 and 16-byte aligned columns (Wᵀ).
//
// hadamard_quest_kernel (other strides and alignments): one block owns a
// 32-row x 32-column tile (one group column), loaded through whichever axis
// has unit stride into shared memory; each warp quantizes whole groups, one
// element per lane, the Hadamard as 5 __shfl_xor_sync butterfly stages, the
// rms as a butterfly warp sum.

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
constexpr int kSqrt2Mantissa = 0x3504f4;  // mantissa of the smallest f32 above sqrt(2)

// E8M0-nearest scale of a group from its sum of squares: c*·rms/6, the
// exponent from the mantissa against sqrt(2)
__device__ __forceinline__ float e8m0_nearest_scale(float sumsq, float clip_c) {
  const float rms = __fsqrt_rn(__fmul_rn(sumsq, 0.03125f));
  const float raw = fmaxf(__fdiv_rn(__fmul_rn(rms, clip_c), 6.f), kMinScale);
  const int bits = __float_as_int(raw);
  int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kSqrt2Mantissa ? 1 : 0);
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// 2^-e for an E8M0 scale 2^e, e in [-126, 127], exact (2^-127 is subnormal):
// v·2^-e is the correctly rounded v / 2^e, so it equals __fdiv_rn(v, scale)
__device__ __forceinline__ float inv_pow2(float scale) {
  const int e = ((__float_as_int(scale) >> 23) & 0xff) - 127;
  return e < 127 ? __int_as_float((127 - e) << 23) : __int_as_float(0x00400000);
}

// The half-code int8(2·RTN_E2M1(clip(q, ±6))), round-to-nearest-even with
// one mantissa bit per binade, written with exact scalings: 2·RTN(a) =
// rint(a·2/pw)·pw for |q| = a in the binade of pw (1 below 2, also for
// a < 1, then 2, then 4), since a/pw·2, the rint and the product by pw are
// all exact.
__device__ __forceinline__ int e2m1_half_code(float q) {
  const float a = fminf(fabsf(q), 6.f);
  const float s = a >= 4.f ? 0.5f : (a >= 2.f ? 1.f : 2.f);
  const float pw = a >= 4.f ? 4.f : (a >= 2.f ? 2.f : 1.f);
  const int mag = static_cast<int>(__fmul_rn(rintf(__fmul_rn(a, s)), pw));
  return q < 0.f ? -mag : mag;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hadamard_quest_kernel(
    const T* __restrict__ x, long long M, long long K, long long sm, long long sk,
    int8_t* __restrict__ codes, float* __restrict__ scales, bool* __restrict__ mask,
    float clip_c) {
  __shared__ float tile[kRows][kGroup + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long k0 = static_cast<long long>(blockIdx.y) * kGroup;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * kGroup; i += kThreads) {
    int r, c;
    if (sk == 1) {  // row-major: consecutive threads walk K
      r = i / kGroup;
      c = i % kGroup;
    } else {  // column-major (transposed weight): consecutive threads walk M
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
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long m = m0 + r;
    if (m >= M) break;  // warp-uniform: rows only grow
    float v = tile[r][lane];
#pragma unroll
    for (int h = 1; h < kGroup; h <<= 1) {
      const float o = __shfl_xor_sync(kFull, v, h);
      v = (lane & h) ? __fsub_rn(o, v) : __fadd_rn(v, o);
    }
    v = __fmul_rn(v, kHadamardScale);

    float ss = __fmul_rn(v, v);
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, h));
    const float scale = e8m0_nearest_scale(ss, clip_c);

    const float q = __fmul_rn(v, inv_pow2(scale));  // = v / scale, exactly
    const long long o = m * K + k0 + lane;
    mask[o] = fabsf(q) <= 6.f;
    codes[o] = static_cast<int8_t>(e2m1_half_code(q));
    if (lane == 0) scales[m * groups + blockIdx.y] = scale;
  }
}

// one fold of the halving sum: v[i] += v[i + N] for i < N
template <int N>
__device__ __forceinline__ void halving_fold(float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __fadd_rn(v[i], v[i + N]);
}

// the vector bodies' group (group_quant.cuh): the plain version's arithmetic
// in its order on one whole 32-group in registers; returns the scale, the
// 32 codes (w[0]) and the 32 mask bytes (w[1]) as words
struct hadamard_quest_group {
  static constexpr int kOuts = 2;
  uint8_t* out[kOuts];  // codes, mask
  float* scales;
  float clip_c;

  __device__ __forceinline__ float operator()(float (&v)[kGroup], long long, long long,
                                              long long, uint32_t (&w)[kOuts][8]) const {
    group_quant::butterfly_stage<1>(v);
    group_quant::butterfly_stage<2>(v);
    group_quant::butterfly_stage<4>(v);
    group_quant::butterfly_stage<8>(v);
    group_quant::butterfly_stage<16>(v);
    float sq[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      v[i] = __fmul_rn(v[i], kHadamardScale);
      sq[i] = __fmul_rn(v[i], v[i]);
    }
    halving_fold<16>(sq);
    halving_fold<8>(sq);
    halving_fold<4>(sq);
    halving_fold<2>(sq);
    halving_fold<1>(sq);
    const float scale = e8m0_nearest_scale(sq[0], clip_c);
    const float inv = inv_pow2(scale);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[0][j] = 0u;
      w[1][j] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = __fmul_rn(v[4 * j + e], inv);
        w[0][j] |= static_cast<uint32_t>(e2m1_half_code(q) & 0xff) << (8 * e);
        w[1][j] |= static_cast<uint32_t>(fabsf(q) <= 6.f) << (8 * e);
      }
    }
    return scale;
  }
};

}  // namespace

// x [M, K] with element strides (sm, sk), f32 (is_bf16 = 0) or bf16; writes
// codes int8 [M, K], scales f32 [M, K/32], mask bool [M, K] (all contiguous,
// 16-byte aligned).  vector = 1 runs the vector body (x must satisfy
// vector_ok, else cudaErrorInvalidValue), 0 the tile body.
extern "C" int hadamard_quest_quantize(const void* x, int is_bf16, long long M, long long K,
                                       long long sm, long long sk, void* codes, void* scales,
                                       void* mask, float clip_c, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    if (!group_quant::vector_ok(x, is_bf16 ? 2 : 4, M, sm, sk))
      return static_cast<int>(cudaErrorInvalidValue);
    const hadamard_quest_group q = {
        {static_cast<uint8_t*>(codes), static_cast<uint8_t*>(mask)}, static_cast<float*>(scales),
        clip_c};
    return is_bf16 ? group_quant::launch<__nv_bfloat16>(x, M, K, sm, sk, q, s)
                   : group_quant::launch<float>(x, M, K, sm, sk, q, s);
  }
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows),
                  static_cast<unsigned>(K / kGroup));
  if (is_bf16) {
    hadamard_quest_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, sm, sk, static_cast<int8_t*>(codes),
        static_cast<float*>(scales), static_cast<bool*>(mask), clip_c);
  } else {
    hadamard_quest_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), M, K, sm, sk, static_cast<int8_t*>(codes),
        static_cast<float*>(scales), static_cast<bool*>(mask), clip_c);
  }
  return static_cast<int>(cudaGetLastError());
}
