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
// sign from bit 3, times 2^(code-127) built from the bits (code 0 gives 0,
// code 255 +inf); one f32 multiply, as the plain version does, then f32 or
// one rounding to bf16 (exact: the value has at most 2 significant bits and
// f32's exponent range, subnormals kept).
//
// Bound on H100: bytes.  Quantize reads 2 or 4 B per element and writes
// 0.5 + 1/32 B; dequantize reads 0.5 + 1/32 B and writes 2 or 4 B; a few
// integer and float operations per element.  At the engine's shapes (a
// layer's K and V rows of one decode or prefill tick: 32 KB to 2 MB of bf16
// input) a launch takes far longer than its bytes, so the KV write of a
// layer is one launch: one grid over both sources (K and V), the source
// picked by blockIdx.y.  The gather of a decode tick (all layers' pages of
// every slot, K and V: 0.59 GB of bf16 at qwen3-1.7b) is bound by its
// stores, so it too is one launch over both sources, and its stores are
// whole 16-byte vectors, consecutive across a warp.
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
// Dequantize: the output is cut into equal chunks (a page of one layer of
// one slot when gathering: ps·H·K/2 code bytes, 8192 at qwen3-1.7b; whole
// rows of at most kTile bytes in the 2-d form) and a CTA takes one tile of
// at most kTile code bytes of one chunk, of source blockIdx.y.  It finds
// its source chunk once, (c / (B·P))·n_pages + tables[c % (B·P)] (the one
// runtime division, and the one 64-bit offset, of the CTA), stages the
// tile's scale bytes and the 16 signed E2M1 values in shared memory, and
// then each thread takes 16 bytes of output at a time (4 code bytes for
// bf16, 2 for f32): one 4- or 2-byte load, one scale byte, an f32 multiply
// an element, one 16-byte store; consecutive threads on consecutive
// vectors, so a warp's stores cover 512 contiguous bytes.  Index math inside
// the tile is 32-bit, by compile-time shifts.
//
// The head-wide block (a head dim that 32 does not divide takes the whole
// head as one block, as the reference's quant_block does: zamba2-7b's 112).
// Quantize: one thread owns one row of 112 in registers (14 or 28 16-byte
// loads through the strides, or scalar loads), the same absmax, exponent
// and nibbles as the 32-group body; a row's 56 code bytes start 56 bytes
// after the previous row's, so they leave as seven 8-byte stores, and its
// scale as one byte.  Dequantize: the 32-group body's loop over tiles of
// whole rows (146 rows, 8176 code bytes, at most kTile), the tile's scale
// bytes staged one a row, a vector's scale the one at code byte / 56 (a
// constant division); chunks and totals are whole rows.  The 32-group
// bodies are untouched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "group_quant.cuh"

namespace {

using group_quant::kGroup;
using group_quant::to_f32;
constexpr int kThreads = 256;
constexpr float kMinScale = 1.17549435082228750797e-38f;  // 2^-126
constexpr int kSqrt2Mantissa = 0x3504f4;  // mantissa of the smallest f32 above sqrt(2)

// 16 bytes of output from 4 f32 values, or from 8 rounded once to bf16
// (cvt.rn.bf16x2.f32: subnormals kept); the first value at the lowest address
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

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

// One source of a dequantize launch: codes [.., chunk] and scales [..,
// chunk / 16] in source chunks, out [n_out_chunks · chunk · 2] (f32 or bf16).
struct DeqSource {
  const uint8_t* codes;
  const uint8_t* scales;
  void* out;
};

struct DeqSources {
  DeqSource s[2];
};

constexpr int kTile = 8192;  // code bytes of a CTA at most: a qwen3-1.7b page of one layer
constexpr int kDeqUnroll = 4;  // loads in flight a thread before its first store

// CTA (blockIdx.x, blockIdx.y) dequantizes tile blockIdx.x % tiles of output
// chunk c = blockIdx.x / tiles of source blockIdx.y.  Chunk c reads source
// chunk (c / n_tbl)·n_pages + tables[c % n_tbl], or c without tables; the
// output ends after ``total`` code bytes (the 2-d form's last chunk may be
// short).  A thread's vector: W (u32 for bf16, u16 for f32) of codes -> 16
// bytes of output.
template <typename T>
__global__ void __launch_bounds__(kThreads) kv_dequant_kernel(
    const DeqSources src, const int* __restrict__ tables, int n_tbl, long long n_pages,
    unsigned chunk, unsigned tiles, long long total) {
  constexpr int kBytes = 8 / sizeof(T);  // code bytes a thread-vector: 4 (bf16) or 2 (f32)
  using W = typename std::conditional<kBytes == 4, uint32_t, uint16_t>::type;
  __shared__ float lut[16];
  __shared__ uint8_t sc[kTile / 16];
  const DeqSource s = blockIdx.y ? src.s[1] : src.s[0];  // no dynamic index into the params
  const unsigned c = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long out_base = static_cast<long long>(c) * chunk + tile * kTile;
  const long long left = total - out_base;
  if (left <= 0) return;  // past the 2-d form's short last chunk: the whole CTA
  const unsigned n = static_cast<unsigned>(
      min(static_cast<long long>(min(static_cast<unsigned>(kTile), chunk - tile * kTile)), left));
  const unsigned nt = static_cast<unsigned>(n_tbl);
  const long long src_chunk = tables != nullptr ? (c / nt) * n_pages + tables[c % nt]
                                                : static_cast<long long>(c);
  const long long in_base = src_chunk * chunk + tile * kTile;
  const uint8_t* scales = s.scales + in_base / 16;
  for (unsigned i = threadIdx.x; i < n / 16; i += kThreads) sc[i] = scales[i];
  if (threadIdx.x < 16) lut[threadIdx.x] = e2m1_value(threadIdx.x);
  __syncthreads();

  const W* codes = reinterpret_cast<const W*>(s.codes + in_base);
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(s.out) + 2 * out_base);
  const unsigned items = n / kBytes;
  for (unsigned base = threadIdx.x; base < items; base += kDeqUnroll * kThreads) {
    W w[kDeqUnroll];
#pragma unroll
    for (int u = 0; u < kDeqUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      w[u] = i < items ? __ldg(codes + i) : W(0);
    }
#pragma unroll
    for (int u = 0; u < kDeqUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i >= items) break;
      // the vector's 2·kBytes outputs lie in one 32-group (16 code bytes)
      const float scale = __int_as_float(static_cast<int>(sc[i * kBytes / 16]) << 23);
      float v[2 * kBytes];
#pragma unroll
      for (int j = 0; j < kBytes; ++j) {  // byte j: high nibble first
        const unsigned byte = (static_cast<unsigned>(w[u]) >> (8 * j)) & 0xffu;
        v[2 * j] = lut[byte >> 4] * scale;
        v[2 * j + 1] = lut[byte & 0xfu] * scale;
      }
      out[i] = pack16<T>(v);
    }
  }
}

// The head-wide block: one scale for a whole row of KB elements (K == KB,
// 32 does not divide KB; zamba2's attention head of 112).  Thread t of
// source blockIdx.y quantizes row t ((l·N + n)·H + h) as kv_quant_kernel
// quantizes a group: the same absmax, exponent and nibbles, over KB values
// loaded as KB·sizeof(T)/16 16-byte vectors.  A row's KB/2 code bytes start
// KB/2 bytes after the previous row's, so they leave as KB/16 8-byte
// stores; its scale as one byte.
template <typename T, int KB, bool VEC>
__global__ void __launch_bounds__(kQuantThreads) kv_quant_row_kernel(
    const KvSources src, unsigned n_rows, const int* __restrict__ page_ids,
    const int* __restrict__ offsets, unsigned N, unsigned H, long long n_pages, int ps) {
  static_assert(KB % 16 == 0 && KB % kGroup != 0, "a head-wide block of 16k, not 32k, values");
  const KvSource s = blockIdx.y ? src.s[1] : src.s[0];  // no dynamic index into the params
  const unsigned row = blockIdx.x * kQuantThreads + threadIdx.x;
  if (row >= n_rows) return;
  const unsigned lr = row / H, h = row % H;  // lr = l·N + n
  const unsigned l = lr / N, n = lr % N;
  const T* x = static_cast<const T*>(s.x) + l * s.sl + n * s.sn + h * s.sh;

  float v[KB];
  if constexpr (VEC) {
    constexpr int kLoads = KB * static_cast<int>(sizeof(T)) / 16;
    const uint4* src16 = reinterpret_cast<const uint4*>(x);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const uint4 raw = src16[i];
      const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
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
  } else {
#pragma unroll
    for (int i = 0; i < KB; ++i) v[i] = to_f32(x[i]);
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < KB; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float raw = fmaxf(__fdiv_rn(amax, 6.f), kMinScale);
  const int bits = __float_as_int(raw);
  int e = ((bits >> 23) & 0xff) - 127 + ((bits & 0x7fffff) >= kSqrt2Mantissa ? 1 : 0);
  e = min(max(e, -126), 127);
  const float inv = e == 127 ? __int_as_float(0x00400000) : __int_as_float((127 - e) << 23);

  long long dest = row;
  if (page_ids != nullptr) dest = ((l * n_pages + page_ids[n]) * ps + offsets[n]) * H + h;
  uint2* out = reinterpret_cast<uint2*>(s.codes + dest * (KB / 2));
#pragma unroll
  for (int q = 0; q < KB / 16; ++q) {  // 16 values -> 8 bytes, high nibble first
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i / 8] |= e2m1_nibble(__fmul_rn(v[16 * q + i], inv)) << (8 * ((i / 2) % 4) + (i % 2 ? 0 : 4));
    out[q] = make_uint2(w[0], w[1]);
  }
  s.scales[dest] = static_cast<uint8_t>(e + 127);
}

// The head-wide block's dequantize: kv_dequant_kernel's loop over tiles of
// whole rows (KB/2 code bytes and one scale byte a row; kTileBytes =
// kTile rounded down to whole rows), the scale of a vector at code byte b of
// the tile is sc[b / (KB/2)], a division by a constant.  Chunks and the
// output's end are whole rows, so a tile starts on a row and a thread's
// vector (4 or 2 code bytes) lies in one row.
template <typename T, int KB>
__global__ void __launch_bounds__(kThreads) kv_dequant_row_kernel(
    const DeqSources src, const int* __restrict__ tables, int n_tbl, long long n_pages,
    unsigned chunk, unsigned tiles, long long total) {
  constexpr unsigned kRow = KB / 2;                   // code bytes a row
  constexpr unsigned kTileRows = kTile / kRow;        // 146 at KB = 112
  constexpr unsigned kTileBytes = kTileRows * kRow;   // 8176 at KB = 112
  static_assert(kRow % 8 == 0 && kTileBytes % 16 == 0, "tiles of 16-byte vectors");
  constexpr int kBytes = 8 / sizeof(T);  // code bytes a thread-vector: 4 (bf16) or 2 (f32)
  using W = typename std::conditional<kBytes == 4, uint32_t, uint16_t>::type;
  __shared__ float lut[16];
  __shared__ uint8_t sc[kTileRows];
  const DeqSource s = blockIdx.y ? src.s[1] : src.s[0];  // no dynamic index into the params
  const unsigned c = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long out_base = static_cast<long long>(c) * chunk + tile * kTileBytes;
  const long long left = total - out_base;
  if (left <= 0) return;  // past the 2-d form's short last chunk: the whole CTA
  const unsigned n = static_cast<unsigned>(
      min(static_cast<long long>(min(kTileBytes, chunk - tile * kTileBytes)), left));
  const unsigned nt = static_cast<unsigned>(n_tbl);
  const long long src_chunk = tables != nullptr ? (c / nt) * n_pages + tables[c % nt]
                                                : static_cast<long long>(c);
  const long long in_base = src_chunk * chunk + tile * kTileBytes;
  const uint8_t* scales = s.scales + in_base / kRow;
  for (unsigned i = threadIdx.x; i < n / kRow; i += kThreads) sc[i] = scales[i];
  if (threadIdx.x < 16) lut[threadIdx.x] = e2m1_value(threadIdx.x);
  __syncthreads();

  const W* codes = reinterpret_cast<const W*>(s.codes + in_base);
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(s.out) + 2 * out_base);
  const unsigned items = n / kBytes;
  for (unsigned base = threadIdx.x; base < items; base += kDeqUnroll * kThreads) {
    W w[kDeqUnroll];
#pragma unroll
    for (int u = 0; u < kDeqUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      w[u] = i < items ? __ldg(codes + i) : W(0);
    }
#pragma unroll
    for (int u = 0; u < kDeqUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i >= items) break;
      const float scale = __int_as_float(static_cast<int>(sc[i * kBytes / kRow]) << 23);
      float v[2 * kBytes];
#pragma unroll
      for (int j = 0; j < kBytes; ++j) {  // byte j: high nibble first
        const unsigned byte = (static_cast<unsigned>(w[u]) >> (8 * j)) & 0xffu;
        v[2 * j] = lut[byte >> 4] * scale;
        v[2 * j + 1] = lut[byte & 0xfu] * scale;
      }
      out[i] = pack16<T>(v);
    }
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

// the head-wide blocks the library is built for (kv_pack.HEAD_BLOCKS)
constexpr int kHeadBlock = 112;

template <typename T>
int launch_quant_rows(const KvSources& src, int n_src, bool vec, unsigned n_rows, const int* pid,
                      const int* off, unsigned N, unsigned H, long long n_pages, int ps,
                      cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n_rows + kQuantThreads - 1) / kQuantThreads),
                  static_cast<unsigned>(n_src));
  if (vec)
    kv_quant_row_kernel<T, kHeadBlock, true><<<grid, kQuantThreads, 0, s>>>(
        src, n_rows, pid, off, N, H, n_pages, ps);
  else
    kv_quant_row_kernel<T, kHeadBlock, false><<<grid, kQuantThreads, 0, s>>>(
        src, n_rows, pid, off, N, H, n_pages, ps);
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

// n_src (1 or 2) sources in one launch, each out_i [n_out_chunks · chunk ·
// 2] values (f32 or bf16, 16-byte aligned) from codes_i (4-byte aligned)
// and scales_i, ending after ``total`` code bytes (<= n_out_chunks ·
// chunk; chunk and total multiples of 16, chunk < 2^31).  Without tables,
// chunk c reads source chunk c; with tables int32 [n_tbl] (B·P entries),
// chunk c reads (c / n_tbl)·n_pages + tables[c % n_tbl] of codes_i [..,
// chunk] and scales_i [.., chunk / 16].
extern "C" int kv_gather_dequant(int n_src, const void* const* codes, const void* const* scales,
                                 void* const* out, const void* tables, long long n_out_chunks,
                                 long long chunk, long long total, int n_tbl, long long n_pages,
                                 int out_bf16, void* stream) {
  if (n_src < 1 || n_src > 2 || chunk <= 0 || chunk % 16 || chunk >= (1LL << 31) || total % 16 ||
      total > n_out_chunks * chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (chunk + kTile - 1) / kTile;
  if (n_out_chunks * tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  DeqSources src = {};
  for (int i = 0; i < n_src; ++i)
    src.s[i] = {static_cast<const uint8_t*>(codes[i]), static_cast<const uint8_t*>(scales[i]),
                out[i]};
  const dim3 grid(static_cast<unsigned>(n_out_chunks * tiles), static_cast<unsigned>(n_src));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(tables);
  if (out_bf16)
    kv_dequant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        src, t, n_tbl, n_pages, static_cast<unsigned>(chunk), static_cast<unsigned>(tiles), total);
  else
    kv_dequant_kernel<float><<<grid, kThreads, 0, s>>>(
        src, t, n_tbl, n_pages, static_cast<unsigned>(chunk), static_cast<unsigned>(tiles), total);
  return static_cast<int>(cudaGetLastError());
}

// kv_quant_scatter with the head-wide block: K == 112 values a row, one
// scale a row (scales [.., 1]), codes 8-byte aligned; otherwise as
// kv_quant_scatter (fewer than 2^31 rows).
extern "C" int kv_quant_scatter_rows(int n_src, const void* const* x, const long long* strides,
                                     int is_bf16, int vec, int L, int N, int H, int K,
                                     const void* page_ids, const void* offsets,
                                     long long n_pages, int ps, void* const* codes,
                                     void* const* scales, void* stream) {
  if (n_src < 1 || n_src > 2 || K != kHeadBlock) return static_cast<int>(cudaErrorInvalidValue);
  KvSources src = {};
  for (int i = 0; i < n_src; ++i)
    src.s[i] = {x[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2],
                static_cast<uint8_t*>(codes[i]), static_cast<uint8_t*>(scales[i])};
  const long long n_rows = static_cast<long long>(L) * N * H;
  if (n_rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pid = static_cast<const int*>(page_ids);
  const auto* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_quant_rows<__nv_bfloat16>(src, n_src, vec, n_rows, pid, off, N, H,
                                                    n_pages, ps, s)
                 : launch_quant_rows<float>(src, n_src, vec, n_rows, pid, off, N, H, n_pages,
                                            ps, s);
}

// kv_gather_dequant with the head-wide block: rows of row_bytes == 56 code
// bytes (K = 112) and one scale byte; chunk and total whole rows, chunk <
// 2^31; otherwise as kv_gather_dequant.
extern "C" int kv_gather_dequant_rows(int n_src, const void* const* codes,
                                      const void* const* scales, void* const* out,
                                      const void* tables, long long n_out_chunks,
                                      long long chunk, long long total, int n_tbl,
                                      long long n_pages, int row_bytes, int out_bf16,
                                      void* stream) {
  constexpr long long kRow = kHeadBlock / 2;
  constexpr long long kTileBytes = kTile / kRow * kRow;
  if (n_src < 1 || n_src > 2 || row_bytes != kRow || chunk <= 0 || chunk % kRow ||
      chunk >= (1LL << 31) || total % kRow || total > n_out_chunks * chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (chunk + kTileBytes - 1) / kTileBytes;
  if (n_out_chunks * tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  DeqSources src = {};
  for (int i = 0; i < n_src; ++i)
    src.s[i] = {static_cast<const uint8_t*>(codes[i]), static_cast<const uint8_t*>(scales[i]),
                out[i]};
  const dim3 grid(static_cast<unsigned>(n_out_chunks * tiles), static_cast<unsigned>(n_src));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(tables);
  if (out_bf16)
    kv_dequant_row_kernel<__nv_bfloat16, kHeadBlock><<<grid, kThreads, 0, s>>>(
        src, t, n_tbl, n_pages, static_cast<unsigned>(chunk), static_cast<unsigned>(tiles), total);
  else
    kv_dequant_row_kernel<float, kHeadBlock><<<grid, kThreads, 0, s>>>(
        src, t, n_tbl, n_pages, static_cast<unsigned>(chunk), static_cast<unsigned>(tiles), total);
  return static_cast<int>(cudaGetLastError());
}
