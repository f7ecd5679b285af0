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
// Design: one block owns a 32-row x 32-column tile (one group column).  The
// load walks whichever axis of x has unit stride, so both the activations
// ([M, K] row-major) and the transposed weight view (Wᵀ, column-major) are
// read with coalesced accesses and without a transpose copy.  Each warp then
// quantizes whole groups: one element per lane, the Hadamard as 5
// __shfl_xor_sync butterfly stages, the rms as a butterfly warp sum.  All
// arithmetic uses the _rn intrinsics (never contracted into FMAs) and the
// E8M0/E2M1 roundings are integer/bit arithmetic, so the kernel is bit-exact
// with hadamard_quest_quantize_plain in repro_torch/kernels/hadamard_quant.py,
// which sums in the same order.

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
constexpr int kSqrt2Mantissa = 0x3504f4;  // mantissa of the smallest f32 above sqrt(2)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// E2M1 round-to-nearest-even of v in [-6, 6]: one mantissa bit per binade.
__device__ __forceinline__ float rtn_e2m1(float v) {
  const float a = fabsf(v);
  const float pw = a >= 4.f ? 4.f : (a >= 2.f ? 2.f : 1.f);
  const float q_norm = __fmul_rn(__fmul_rn(rintf(__fmul_rn(__fdiv_rn(a, pw), 2.f)), 0.5f), pw);
  const float q_sub = __fmul_rn(rintf(__fmul_rn(a, 2.f)), 0.5f);
  const float q = a >= 1.f ? q_norm : q_sub;
  return v < 0.f ? -q : q;
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
    const float rms = __fsqrt_rn(__fmul_rn(ss, 0.03125f));
    const float raw = fmaxf(__fdiv_rn(__fmul_rn(rms, clip_c), 6.f), kMinScale);

    const int bits = __float_as_int(raw);
    int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kSqrt2Mantissa ? 1 : 0);
    e = min(max(e, -126), 127);
    const float scale = __int_as_float((e + 127) << 23);

    const float q = __fdiv_rn(v, scale);
    const long long o = m * K + k0 + lane;
    mask[o] = fabsf(q) <= 6.f;
    codes[o] = static_cast<int8_t>(rintf(__fmul_rn(rtn_e2m1(fminf(fmaxf(q, -6.f), 6.f)), 2.f)));
    if (lane == 0) scales[m * groups + blockIdx.y] = scale;
  }
}

}  // namespace

// x [M, K] with element strides (sm, sk), f32 (is_bf16 = 0) or bf16; writes
// codes int8 [M, K], scales f32 [M, K/32], mask bool [M, K] (all contiguous).
extern "C" int hadamard_quest_quantize(const void* x, int is_bf16, long long M, long long K,
                                       long long sm, long long sk, void* codes, void* scales,
                                       void* mask, float clip_c, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows),
                  static_cast<unsigned>(K / kGroup));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
