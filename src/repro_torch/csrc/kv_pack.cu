// MXFP4 KV-page quantize-pack (optionally scattered into the paged pool) and
// unpack-dequantize (optionally gathered through the page tables).
//
// Replaces the Pallas TPU kernels of repro/kernels/kv_pack.py: kv_quant_pack
// (body _kv_quant_pack_kernel) and kv_dequant_unpack (body
// _kv_dequant_unpack_kernel -> unpack_dequant).
//
// Quantize, per 32-element group of a row: amax = max |x|; e =
// E8M0-nearest(max(amax/6, 2^-126)) clipped to [-126, 127]; q =
// RTN_E2M1(clip(x·2^-e, ±6)) with ties to even; the 4-bit code S|EE|M, two
// per byte with the even element in the high nibble; the scale byte e + 127.
// Dequantize: |v| = 2^((i-2)>>1)·(1 + (i&1)/2) for i >= 2, i/2 below, the
// sign from bit 3, times 2^(code-127); written as f32 or bf16 (exact: the
// value has at most 2 significant bits and f32's exponent range).
//
// Bound on H100: bytes.  Quantize reads 2 or 4 B per element and writes
// 0.5 + 1/32 B; dequantize reads 0.5 + 1/32 B and writes 2 or 4 B; a few
// integer and float operations per element.  At the engine's shapes (a
// layer's K and V rows of one decode or prefill tick: 32 KB to 2 MB of bf16
// input) a launch takes far longer than its bytes, so the KV write of a
// layer is one launch: one grid over both sources (K and V), the source
// picked by blockIdx.y.
//
// Design.  Quantize: one thread owns a whole 32-group in registers — four
// (bf16) or eight (f32) 16-byte loads (group_quant.cuh's load_group, shared
// with the grouped Hadamard quantizers), read through the input's strides
// (the gather backend's strided slices of its dense caches are not copied);
// the absmax; the exponent from the bits of amax/6 (the mantissa compared
// with sqrt(2)'s, never log2f, which misrounds near sqrt(2)·2^k), once a
// group; the scaling multiplies by 2^-e built from the bits, which equals
// the IEEE division by 2^e, so the round-to-nearest ties fall as in the
// plain version; the RTN as rint(|q|·2/pw) in the binade of pw, each step
// exact.  The group's 32 nibbles leave as one 16-byte store and its scale as
// one byte.  With page ids, row (l, n, h) of the [L, N, H, K] input lands at
// ((l·n_pages + page[n])·ps + offset[n])·H + h of the pool leaf, in place.
// Inputs that 16-byte loads cannot read take the same body with scalar
// loads.
// Dequantize: one thread per packed byte (two outputs); the output is cut
// into equal chunks (a page of one layer when gathering) and chunk c reads
// the source chunk (c / (B·P))·n_pages + tables[c % (B·P)].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_quant.cuh"

namespace {

using group_quant::kGroup;
using group_quant::to_f32;
constexpr int kThreads = 256;
constexpr float kMinScale = 1.17549435082228750797e-38f;  // 2^-126
constexpr int kSqrt2Mantissa = 0x3504f4;  // mantissa of the smallest f32 above sqrt(2)

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The 4-bit code S|EE|M of RTN_E2M1(clip(v, ±6)) (ties to even; a value
// that rounds to zero has code 0, its sign dropped).  In the binade of pw
// (1 below 2, also for |v| < 1, then 2, then 4), r = rint(|v|·2/pw) is exact
// and the grid index is r + 2·log2(pw): 0..4 below 2 (0, 0.5, 1, 1.5, 2),
// 4..6 in [2, 4) (2, 3, 4), 6..7 from 4 (4, 6).
__device__ __forceinline__ uint32_t e2m1_nibble(float v) {
  const float a = fminf(fabsf(v), 6.f);
  const float s = a >= 4.f ? 0.5f : (a >= 2.f ? 1.f : 2.f);
  const int idx = static_cast<int>(rintf(__fmul_rn(a, s))) + (a >= 4.f ? 4 : (a >= 2.f ? 2 : 0));
  return static_cast<uint32_t>(idx | (v < 0.f && idx != 0 ? 8 : 0));
}

// 4-bit code -> E2M1 value
__device__ __forceinline__ float e2m1_value(int nib) {
  const int i = nib & 7;
  const float mag = i >= 2 ? __int_as_float((((i - 2) >> 1) + 127) << 23) * (1.f + 0.5f * (i & 1))
                           : 0.5f * i;
  return (nib & 8) ? -mag : mag;
}

// One source of a quantize launch: x [L, N, H, K] at element strides (sl,
// sn, sh) with unit stride along K, into codes [.., K/2] and scales [..,
// K/32] (pool leaves [L, n_pages, ps, H, ..] with page ids, else [L·N·H, ..]).
struct KvSource {
  const void* x;
  long long sl, sn, sh;
  uint8_t* codes;
  uint8_t* scales;
};

struct KvSources {
  KvSource s[2];
};

constexpr int kQuantThreads = 128;

// thread t of source blockIdx.y quantizes group t (row t / gpr, group t %
// gpr; row = (l·N + n)·H + h), index math in 32 bits (the entry refuses
// 2^31 groups or more); VEC: x, its strides and its rows are 16-byte aligned
template <typename T, bool VEC>
__global__ void __launch_bounds__(kQuantThreads) kv_quant_kernel(
    const KvSources src, unsigned n_groups, unsigned gpr, const int* __restrict__ page_ids,
    const int* __restrict__ offsets, unsigned N, unsigned H, long long n_pages, int ps) {
  const KvSource s = blockIdx.y ? src.s[1] : src.s[0];  // no dynamic index into the params
  const unsigned t = blockIdx.x * kQuantThreads + threadIdx.x;
  if (t >= n_groups) return;
  const unsigned row = t / gpr, g = t % gpr;
  const unsigned lr = row / H, h = row % H;  // lr = l·N + n
  const unsigned l = lr / N, n = lr % N;
  const T* x = static_cast<const T*>(s.x) + l * s.sl + n * s.sn + h * s.sh + g * kGroup;

  float v[kGroup];
  if constexpr (VEC) {
    group_quant::load_group<T>(x, v);
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) v[i] = to_f32(x[i]);
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float raw = fmaxf(__fdiv_rn(amax, 6.f), kMinScale);
  const int bits = __float_as_int(raw);
  int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kSqrt2Mantissa ? 1 : 0);
  e = min(max(e, -126), 127);
  // 2^-e: normal for e <= 126, the subnormal 2^-127 for e = 127
  const float inv = e == 127 ? __int_as_float(0x00400000) : __int_as_float((127 - e) << 23);

  // byte j = (nibble 2j << 4) | nibble 2j + 1, little-endian in word j / 4
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    w[i / 8] |= e2m1_nibble(__fmul_rn(v[i], inv)) << (8 * ((i / 2) % 4) + (i % 2 ? 0 : 4));

  long long dest = row;
  if (page_ids != nullptr) dest = ((l * n_pages + page_ids[n]) * ps + offsets[n]) * H + h;
  *reinterpret_cast<uint4*>(s.codes + dest * (gpr * kGroup / 2) + g * (kGroup / 2)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  s.scales[dest * gpr + g] = static_cast<uint8_t>(e + 127);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_dequant_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ scales,
    const int* __restrict__ tables, long long total, long long chunk, int n_tbl,
    long long n_pages, T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long c = i / chunk, j = i % chunk;
    const long long src = tables != nullptr ? (c / n_tbl) * n_pages + tables[c % n_tbl] : c;
    const int byte = codes[src * chunk + j];
    const float sc = __int_as_float(static_cast<int>(scales[src * (chunk / 16) + j / 16]) << 23);
    store(out + 2 * i, e2m1_value(byte >> 4) * sc);
    store(out + 2 * i + 1, e2m1_value(byte & 0xf) * sc);
  }
}

template <typename T>
int launch_quant(const KvSources& src, int n_src, bool vec, unsigned n_groups, unsigned gpr,
                 const int* pid, const int* off, unsigned N, unsigned H, long long n_pages, int ps,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n_groups + kQuantThreads - 1) / kQuantThreads),
                  static_cast<unsigned>(n_src));
  if (vec)
    kv_quant_kernel<T, true><<<grid, kQuantThreads, 0, s>>>(src, n_groups, gpr, pid, off, N, H,
                                                            n_pages, ps);
  else
    kv_quant_kernel<T, false><<<grid, kQuantThreads, 0, s>>>(src, n_groups, gpr, pid, off, N, H,
                                                             n_pages, ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_src (1 or 2) sources in one launch, each x_i [L, N, H, K] (f32 or bf16,
// element strides (sl_i, sn_i, sh_i), unit stride along K, K % 32 == 0,
// fewer than 2^31 groups of 32)
// into codes_i / scales_i (16-byte aligned).  Without page ids (page_ids =
// NULL) row (l, n, h) is written at row (l·N + n)·H + h of codes u8
// [.., K/2] and scales u8 [.., K/32]; with page ids/offsets int32 [N] at
// ((l·n_pages + page[n])·ps + offset[n])·H + h of the pool leaves [L,
// n_pages, ps, H, K/2] and [L, n_pages, ps, H, K/32].  vec = 1: every x_i
// and its strides are 16-byte aligned (16-byte loads).
extern "C" int kv_quant_scatter(int n_src, const void* const* x, const long long* strides,
                                int is_bf16, int vec, int L, int N, int H, int K,
                                const void* page_ids, const void* offsets, long long n_pages,
                                int ps, void* const* codes, void* const* scales, void* stream) {
  if (n_src < 1 || n_src > 2) return static_cast<int>(cudaErrorInvalidValue);
  KvSources src = {};
  for (int i = 0; i < n_src; ++i)
    src.s[i] = {x[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2],
                static_cast<uint8_t*>(codes[i]), static_cast<uint8_t*>(scales[i])};
  const int gpr = K / kGroup;
  const long long n_groups = static_cast<long long>(L) * N * H * gpr;
  if (n_groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pid = static_cast<const int*>(page_ids);
  const auto* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_quant<__nv_bfloat16>(src, n_src, vec, n_groups, gpr, pid, off, N, H,
                                               n_pages, ps, s)
                 : launch_quant<float>(src, n_src, vec, n_groups, gpr, pid, off, N, H, n_pages,
                                       ps, s);
}

// Output [n_out_chunks · chunk · 2] values (f32 or bf16); chunk = packed
// bytes per chunk (a multiple of 16).  Without tables, chunk c reads source
// chunk c; with tables int32 [n_tbl] (B·P entries), chunk c reads
// (c / n_tbl)·n_pages + tables[c % n_tbl] of codes [.., chunk] and scales
// [.., chunk / 16].
extern "C" int kv_gather_dequant(const void* codes, const void* scales, const void* tables,
                                 long long n_out_chunks, long long chunk, int n_tbl,
                                 long long n_pages, void* out, int out_bf16, void* stream) {
  const long long total = n_out_chunks * chunk;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* sc = static_cast<const uint8_t*>(scales);
  const auto* t = static_cast<const int*>(tables);
  if (out_bf16)
    kv_dequant_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        c, sc, t, total, chunk, n_tbl, n_pages, static_cast<__nv_bfloat16*>(out));
  else
    kv_dequant_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        c, sc, t, total, chunk, n_tbl, n_pages, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
