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
// integer and float operations per element.
//
// Design.  Quantize: one warp per 32-group, one element per lane; the
// absmax by __shfl_xor_sync; the exponent from the bits of amax/6 (the
// mantissa compared with sqrt(2)'s, never log2f, which misrounds near
// sqrt(2)·2^k); the scaling multiplies by 2^-e built from the bits, which
// equals the IEEE division by 2^e, so the round-to-nearest ties fall as in
// the plain version.  The odd lane's nibble reaches the even lane by one
// shuffle.  With page ids, row (l, n, h) of the [L, N, H, K] input lands at
// ((l·n_pages + page[n])·ps + offset[n])·H + h of the pool leaf, in place.
// Dequantize: one thread per packed byte (two outputs); the output is cut
// into equal chunks (a page of one layer when gathering) and chunk c reads
// the source chunk (c / (B·P))·n_pages + tables[c % (B·P)].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinScale = 1.17549435082228750797e-38f;  // 2^-126
constexpr int kSqrt2Mantissa = 0x3504f4;  // mantissa of the smallest f32 above sqrt(2)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// E2M1 round-to-nearest-even of v in [-6, 6]: one mantissa bit per binade.
__device__ __forceinline__ float rtn_e2m1(float v) {
  const float a = fabsf(v);
  const float pw = a >= 4.f ? 4.f : (a >= 2.f ? 2.f : 1.f);
  const float q_norm = __fmul_rn(__fmul_rn(rintf(__fmul_rn(__fdiv_rn(a, pw), 2.f)), 0.5f), pw);
  const float q_sub = __fmul_rn(rintf(__fmul_rn(a, 2.f)), 0.5f);
  const float q = a >= 1.f ? q_norm : q_sub;
  return v < 0.f ? -q : q;
}

// on-grid E2M1 value -> 4-bit code, bit 3 = sign (negative zero -> 0)
__device__ __forceinline__ int e2m1_nibble(float q) {
  const float a = fabsf(q);
  int idx;
  if (a >= 1.f) {
    const float pw = a >= 4.f ? 4.f : (a >= 2.f ? 2.f : 1.f);
    const int e = (a >= 2.f) + (a >= 4.f);
    idx = 2 + 2 * e + static_cast<int>(__fmul_rn(__fdiv_rn(a, pw), 2.f)) - 2;
  } else {
    idx = static_cast<int>(__fmul_rn(a, 2.f));
  }
  return idx | (q < 0.f ? 8 : 0);
}

// 4-bit code -> E2M1 value
__device__ __forceinline__ float e2m1_value(int nib) {
  const int i = nib & 7;
  const float mag = i >= 2 ? __int_as_float((((i - 2) >> 1) + 127) << 23) * (1.f + 0.5f * (i & 1))
                           : 0.5f * i;
  return (nib & 8) ? -mag : mag;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_quant_kernel(
    const T* __restrict__ x, long long n_groups, int gpr, const int* __restrict__ page_ids,
    const int* __restrict__ offsets, int N, int H, long long n_pages, int ps,
    uint8_t* __restrict__ codes, uint8_t* __restrict__ scales) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= n_groups) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long m = w / gpr;
  const int g = static_cast<int>(w % gpr);
  const long long K = static_cast<long long>(gpr) * kGroup;
  const float v = to_f32(x[m * K + g * kGroup + lane]);

  float amax = fabsf(v);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const float raw = fmaxf(__fdiv_rn(amax, 6.f), kMinScale);
  const int bits = __float_as_int(raw);
  int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kSqrt2Mantissa ? 1 : 0);
  e = min(max(e, -126), 127);
  // 2^-e: normal for e <= 126, the subnormal 2^-127 for e = 127
  const float inv = e == 127 ? __int_as_float(0x00400000) : __int_as_float((127 - e) << 23);

  const float q = rtn_e2m1(fminf(fmaxf(__fmul_rn(v, inv), -6.f), 6.f));
  const int nib = e2m1_nibble(q);
  const int odd = __shfl_down_sync(kFull, nib, 1);

  long long dest = m;
  if (page_ids != nullptr) {
    const long long nh = static_cast<long long>(N) * H;
    const long long l = m / nh, r = m % nh;
    const int n = static_cast<int>(r / H), h = static_cast<int>(r % H);
    dest = ((l * n_pages + page_ids[n]) * ps + offsets[n]) * H + h;
  }
  if ((lane & 1) == 0)
    codes[dest * (K / 2) + g * (kGroup / 2) + lane / 2] =
        static_cast<uint8_t>((nib << 4) | (odd & 0xf));
  if (lane == 0) scales[dest * gpr + g] = static_cast<uint8_t>(e + 127);
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

}  // namespace

// x [rows, K] contiguous (f32 or bf16), rows = L·N·H, K % 32 == 0.  Without
// page ids (page_ids = NULL) writes codes u8 [rows, K/2] and scales u8
// [rows, K/32]; with page ids/offsets int32 [N] writes row (l, n, h) into
// the pool leaves [L, n_pages, ps, H, K/2] and [L, n_pages, ps, H, K/32].
extern "C" int kv_quant_scatter(const void* x, int is_bf16, long long rows, int K,
                                const void* page_ids, const void* offsets, int N, int H,
                                long long n_pages, int ps, void* codes, void* scales,
                                void* stream) {
  const int gpr = K / kGroup;
  const long long n_groups = rows * gpr;
  const dim3 grid(static_cast<unsigned>((n_groups + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pid = static_cast<const int*>(page_ids);
  const auto* off = static_cast<const int*>(offsets);
  auto* c = static_cast<uint8_t*>(codes);
  auto* sc = static_cast<uint8_t*>(scales);
  if (is_bf16)
    kv_quant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n_groups, gpr, pid, off, N, H, n_pages, ps, c, sc);
  else
    kv_quant_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n_groups, gpr, pid, off, N, H, n_pages, ps, c, sc);
  return static_cast<int>(cudaGetLastError());
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
