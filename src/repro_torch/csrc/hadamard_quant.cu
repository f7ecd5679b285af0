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
// — the five butterfly stages, the halving sum, no shuffle.  Codes and
// mask leave as 16-byte stores, paired across lanes so that each store
// instruction writes whole 32-byte sectors.
//   hadamard_quest_rows_kernel, row-major x (activations): thread (m, g)
//   reads its group as 4 (bf16) or 8 (f32) 16-byte loads; consecutive
//   threads take consecutive groups of a row, so a warp reads and writes
//   contiguous bytes.
//   hadamard_quest_cols_kernel, the transposed weight view Wᵀ (unit stride
//   along M): a CTA of 128 threads owns 128 rows and walks a run of group
//   columns, each column's [32 k x 128 m] tile staged through shared memory
//   by cp.async of 16 bytes along M (whole 128-byte lines of the weight,
//   read in place, no transpose copy), two stages so the next column loads
//   while each thread quantizes its row's group from this one; the grid is
//   about 8 CTAs a SM (a 2048 x 6144 weight: 48 x 22).
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

#include "sm90_mma.cuh"

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

constexpr int kVecThreads = 256;

// butterfly stage H over a 32-group in registers: the element with bit H
// clear keeps a + b, the other a − b
template <int H>
__device__ __forceinline__ void butterfly_stage(float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (!(i & H)) {
      const float a = v[i], b = v[i + H];
      v[i] = __fadd_rn(a, b);
      v[i + H] = __fsub_rn(a, b);
    }
}

// one fold of the halving sum: v[i] += v[i + N] for i < N
template <int N>
__device__ __forceinline__ void halving_fold(float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __fadd_rn(v[i], v[i + N]);
}

// one whole 32-group in registers: the plain version's arithmetic in its
// order; returns the scale, the 32 codes and the 32 mask bytes as words
__device__ __forceinline__ float quantize_group(float (&v)[kGroup], float clip_c,
                                                uint32_t (&cw)[8], uint32_t (&mw)[8]) {
  butterfly_stage<1>(v);
  butterfly_stage<2>(v);
  butterfly_stage<4>(v);
  butterfly_stage<8>(v);
  butterfly_stage<16>(v);
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
  for (int w = 0; w < 8; ++w) {
    cw[w] = 0u;
    mw[w] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = __fmul_rn(v[4 * w + e], inv);
      cw[w] |= static_cast<uint32_t>(e2m1_half_code(q) & 0xff) << (8 * e);
      mw[w] |= static_cast<uint32_t>(fabsf(q) <= 6.f) << (8 * e);
    }
  }
  return scale;
}

// The 32 code bytes of this lane's group and of its partner's (lane ^ 1),
// written so that each store instruction fills whole 32-byte sectors: the
// even lane's group goes out first (its first half from the even lane, its
// second from the odd), then the odd lane's.  `own` / `other` are the byte
// offsets of this lane's and the partner's group, -1 where there is none.
__device__ __forceinline__ void store_pair(uint8_t* __restrict__ base, const uint32_t (&w)[8],
                                           long long own, long long other) {
  const bool odd = threadIdx.x & 1;
  uint32_t y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __shfl_xor_sync(0xffffffffu, odd ? w[i] : w[4 + i], 1);
  const long long even_off = odd ? other : own, odd_off = odd ? own : other;
  if (even_off >= 0)  // even lane's group: [0, 16) from the even lane, [16, 32) from the odd
    *reinterpret_cast<uint4*>(base + even_off + (odd ? 16 : 0)) =
        odd ? make_uint4(y[0], y[1], y[2], y[3]) : make_uint4(w[0], w[1], w[2], w[3]);
  if (odd_off >= 0)  // odd lane's group
    *reinterpret_cast<uint4*>(base + odd_off + (odd ? 16 : 0)) =
        odd ? make_uint4(w[4], w[5], w[6], w[7]) : make_uint4(y[0], y[1], y[2], y[3]);
}

// the group's 32 values from its 16-byte words (8 bf16 or 4 f32 each)
template <typename T>
__device__ __forceinline__ void unpack_group(const uint4 (&raw)[kGroup * sizeof(T) / 16],
                                             float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup * static_cast<int>(sizeof(T)) / 16; ++i) {
    const uint32_t u[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 2) {
        v[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
        v[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
      } else {
        v[4 * i + j] = __uint_as_float(u[j]);
      }
    }
  }
}

// row-major x (unit stride along K): thread (m, g) reads its group as 64 or
// 128 contiguous bytes (4 or 8 loads of 16 B); consecutive threads take
// consecutive groups of a row
template <typename T>
__global__ void __launch_bounds__(kVecThreads) hadamard_quest_rows_kernel(
    const T* __restrict__ x, long long M, long long K, long long sm,
    int8_t* __restrict__ codes, float* __restrict__ scales, bool* __restrict__ mask,
    float clip_c) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte load
  const long long n_g = K / kGroup, n = M * n_g;
  const long long t = static_cast<long long>(blockIdx.x) * kVecThreads + threadIdx.x;
  const bool active = t < n;  // inactive lanes still take part in the pair stores
  const long long m = active ? t / n_g : 0, g = active ? t % n_g : 0;
  uint4 raw[kGroup / EPV];
  const uint4* src = reinterpret_cast<const uint4*>(x + m * sm + g * kGroup);
#pragma unroll
  for (int i = 0; i < kGroup / EPV; ++i) raw[i] = active ? src[i] : make_uint4(0u, 0u, 0u, 0u);
  float v[kGroup];
  unpack_group<T>(raw, v);
  uint32_t cw[8], mw[8];
  const float scale = quantize_group(v, clip_c, cw, mw);
  // group t sits at byte t·32 of codes and mask (rows of K bytes)
  const long long tp = t ^ 1;
  const long long own = active ? t * kGroup : -1, other = tp < n ? tp * kGroup : -1;
  store_pair(reinterpret_cast<uint8_t*>(codes), cw, own, other);
  store_pair(reinterpret_cast<uint8_t*>(mask), mw, own, other);
  if (active) scales[t] = scale;
}

// the transposed weight view (unit stride along M, M % 8 == 0): a CTA of
// 128 threads owns 128 rows and walks a run of group columns; each column's
// [32 k x 128 m] tile comes into shared memory by cp.async of 16 bytes along
// M (whole 128-byte lines), two stages, the next column's copy in flight
// while thread i quantizes row m0 + i's group from column i of this one
constexpr int kColThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kColThreads, 4) hadamard_quest_cols_kernel(
    const T* __restrict__ x, long long M, long long K, long long sk,
    int8_t* __restrict__ codes, float* __restrict__ scales, bool* __restrict__ mask,
    float clip_c, int groups_per_cta) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int CPR = kColThreads / EPV;  // 16-byte chunks of one k of the tile
  __shared__ __align__(16) T tile[2][kGroup][kColThreads];
  const long long m0 = static_cast<long long>(blockIdx.x) * kColThreads;
  const long long n_g = K / kGroup;
  const long long g0 = static_cast<long long>(blockIdx.y) * groups_per_cta;
  const long long g_end = min(g0 + groups_per_cta, n_g);
  const int tid = threadIdx.x;
  auto load = [&](long long g, T (*dst)[kColThreads]) {
    for (int i = tid; i < kGroup * CPR; i += kColThreads) {
      const int k = i / CPR, c = i % CPR;
      const long long m = m0 + c * EPV;
      const bool ok = m < M;
      sm90::cp_async16(&dst[k][c * EPV], ok ? x + m + (g * kGroup + k) * sk : x, ok);
    }
  };
  load(g0, tile[0]);
  sm90::cp_async_commit();
  const long long m = m0 + tid;
  for (long long g = g0; g < g_end; ++g) {
    const int stage = static_cast<int>(g - g0) & 1;
    if (g + 1 < g_end) load(g + 1, tile[stage ^ 1]);  // freed by the last barrier
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // column g has landed
    __syncthreads();
    float v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = to_f32(tile[stage][k][tid]);  // 0 past M
    uint32_t cw[8], mw[8];
    const float scale = quantize_group(v, clip_c, cw, mw);
    const long long mp = m ^ 1;  // the partner lane's row
    const long long own = m < M ? m * K + g * kGroup : -1;
    const long long other = mp < M ? mp * K + g * kGroup : -1;
    store_pair(reinterpret_cast<uint8_t*>(codes), cw, own, other);
    store_pair(reinterpret_cast<uint8_t*>(mask), mw, own, other);
    if (m < M) scales[m * n_g + g] = scale;
    __syncthreads();  // this stage is free for column g + 2
  }
}

// the Wᵀ grid's target, 8 CTAs a SM of the current device: about two
// waves at the 4 a SM that its registers allow (up to 128 a thread, no
// spills), which measured faster than one wave
int resident_col_ctas() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 8 * 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return 8 * sms[dev];
}

template <typename T>
int launch_vec(const void* x, long long M, long long K, long long sm, long long sk, void* codes,
               void* scales, void* mask, float clip_c, cudaStream_t s) {
  const auto* x_ = static_cast<const T*>(x);
  auto* c_ = static_cast<int8_t*>(codes);
  auto* s_ = static_cast<float*>(scales);
  auto* m_ = static_cast<bool*>(mask);
  if (sk == 1) {
    const long long threads = M * (K / kGroup);
    hadamard_quest_rows_kernel<T><<<static_cast<unsigned>((threads + kVecThreads - 1) / kVecThreads),
                                    kVecThreads, 0, s>>>(x_, M, K, sm, c_, s_, m_, clip_c);
  } else {  // about 8 CTAs a SM, each walking its run of columns
    const long long row_blocks = (M + kColThreads - 1) / kColThreads, n_g = K / kGroup;
    const long long per = (row_blocks * n_g + resident_col_ctas() - 1) / resident_col_ctas();
    const int gpc = static_cast<int>(per < 1 ? 1 : per);
    const dim3 grid(static_cast<unsigned>(row_blocks), static_cast<unsigned>((n_g + gpc - 1) / gpc));
    hadamard_quest_cols_kernel<T><<<grid, kColThreads, 0, s>>>(x_, M, K, sk, c_, s_, m_, clip_c,
                                                               gpc);
  }
  return static_cast<int>(cudaGetLastError());
}

// what the vector body's 16-byte accesses need: the same rule as the
// wrapper's _vector_ok
bool vector_ok(const void* x, int es, long long M, long long sm, long long sk) {
  if (reinterpret_cast<uintptr_t>(x) & 15) return false;
  if (sk == 1) return M == 1 || (sm * es) % 16 == 0;
  if (sm == 1) return M % 8 == 0 && (sk * es) % 16 == 0;
  return false;
}

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
    if (!vector_ok(x, is_bf16 ? 2 : 4, M, sm, sk)) return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16 ? launch_vec<__nv_bfloat16>(x, M, K, sm, sk, codes, scales, mask, clip_c, s)
                   : launch_vec<float>(x, M, K, sm, sk, codes, scales, mask, clip_c, s);
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
