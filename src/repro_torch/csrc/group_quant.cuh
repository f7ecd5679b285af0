// One thread per 32-group along K: the vector bodies shared by the grouped
// quantizers hadamard_quant.cu (B1) and sr_hadamard_quant.cu (B2), and the
// 16-byte group load that kv_pack.cu also uses.
//
// A quantizer supplies a per-group functor Q (passed by value as a kernel
// parameter):
//   static constexpr int kOuts;  // byte outputs a group: B1 codes and mask, B2 codes
//   uint8_t* out[kOuts];         // each [M, K], contiguous, 16-byte aligned
//   float* scales;               // [M, K/32], contiguous
//   __device__ float operator()(float (&v)[kGroup], long long m, long long g, long long K,
//                               uint32_t (&w)[kOuts][8]) const;
// which quantizes group g of row m from its 32 values in v (as f32) and
// returns the group's scale and each output's 32 bytes as words.  The
// walkers own the loads and the stores: the group's arithmetic is all the
// functor's.
//
//   rows_kernel, row-major x (unit stride along K): thread (m, g) reads its
//   group as 4 (bf16) or 8 (f32) 16-byte loads; consecutive threads take
//   consecutive groups of a row, so a warp reads and writes contiguous bytes.
//   cols_kernel, unit stride along M (M % 8 == 0; a transposed view): a CTA
//   of 128 threads owns 128 rows and walks a run of group columns, each
//   column's [32 k x 128 m] tile staged through shared memory by cp.async of
//   16 bytes along M (whole 128-byte lines, read in place, no transpose
//   copy), two stages so the next column loads while each thread quantizes
//   its row's group from this one; the grid is about 8 CTAs a SM (a 2048 x
//   6144 weight: 48 x 22).
// Every output leaves as 16-byte stores paired across lanes, so that each
// store instruction writes whole 32-byte sectors (store_pair).  launch()
// picks the walker; vector_ok() is what their 16-byte accesses need.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace group_quant {

constexpr int kGroup = 32;
constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// the group's 32 values from 16-byte loads at x (16-byte aligned): four
// loads of 8 bf16 or eight of 4 f32; zeros where !valid (x unread)
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ x, float (&v)[kGroup],
                                           bool valid = true) {
  constexpr int kLoads = kGroup * static_cast<int>(sizeof(T)) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4 raw[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) raw[i] = valid ? src[i] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
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

// The 32 bytes of this lane's group and of its partner's (lane ^ 1),
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

// group t of the row-major [M, K] operand (row t / (K/32)): its outputs at
// byte t·32 of each (rows of K bytes), its scale at t
template <typename T, class Q>
__global__ void __launch_bounds__(kRowThreads) rows_kernel(const T* __restrict__ x, long long M,
                                                           long long K, long long sm, const Q q) {
  const long long n_g = K / kGroup, n = M * n_g;
  const long long t = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  const bool active = t < n;  // inactive lanes still take part in the pair stores
  const long long m = active ? t / n_g : 0, g = active ? t % n_g : 0;
  float v[kGroup];
  load_group<T>(x + m * sm + g * kGroup, v, active);
  uint32_t w[Q::kOuts][8];
  const float scale = q(v, m, g, K, w);
  const long long tp = t ^ 1;
  const long long own = active ? t * kGroup : -1, other = tp < n ? tp * kGroup : -1;
#pragma unroll
  for (int o = 0; o < Q::kOuts; ++o) store_pair(q.out[o], w[o], own, other);
  if (active) q.scales[t] = scale;
}

// thread i of the CTA quantizes row m0 + i's group from column i of each
// staged [32 k x 128 m] tile
template <typename T, class Q>
__global__ void __launch_bounds__(kColThreads, 4) cols_kernel(const T* __restrict__ x,
                                                              long long M, long long K,
                                                              long long sk, const Q q,
                                                              int groups_per_cta) {
  constexpr int EPV = 16 / sizeof(T);     // elements per 16-byte copy
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
    uint32_t w[Q::kOuts][8];
    const float scale = q(v, m, g, K, w);
    const long long mp = m ^ 1;  // the partner lane's row
    const long long own = m < M ? m * K + g * kGroup : -1;
    const long long other = mp < M ? mp * K + g * kGroup : -1;
#pragma unroll
    for (int o = 0; o < Q::kOuts; ++o) store_pair(q.out[o], w[o], own, other);
    if (m < M) q.scales[m * n_g + g] = scale;
    __syncthreads();  // this stage is free for column g + 2
  }
}

// the cols grid's target, 8 CTAs a SM of the current device: about two
// waves at the 4 a SM that the registers allow (B1's choice, which measured
// faster than one wave for B1)
inline int resident_col_ctas() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 8 * 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return 8 * sms[dev];
}

// what the walkers' 16-byte accesses need (the same rule as the wrappers'
// repro_torch.kernels.hadamard_quant.vector_ok): x 16-byte aligned, and
// 16-byte aligned rows (row-major) or M % 8 == 0 and 16-byte aligned
// columns (unit stride along M); es is the element size in bytes
inline bool vector_ok(const void* x, int es, long long M, long long sm, long long sk) {
  if (reinterpret_cast<uintptr_t>(x) & 15) return false;
  if (sk == 1) return M == 1 || (sm * es) % 16 == 0;
  if (sm == 1) return M % 8 == 0 && (sk * es) % 16 == 0;
  return false;
}

// x [M, K] at element strides (sm, sk), satisfying vector_ok: the rows
// walker for sk == 1, else the cols walker over about 8 CTAs a SM, each
// walking its run of columns
template <typename T, class Q>
int launch(const void* x, long long M, long long K, long long sm, long long sk, const Q& q,
           cudaStream_t s) {
  const auto* x_ = static_cast<const T*>(x);
  if (sk == 1) {
    const long long threads = M * (K / kGroup);
    rows_kernel<T, Q><<<static_cast<unsigned>((threads + kRowThreads - 1) / kRowThreads),
                        kRowThreads, 0, s>>>(x_, M, K, sm, q);
  } else {
    const long long row_blocks = (M + kColThreads - 1) / kColThreads, n_g = K / kGroup;
    const long long per = (row_blocks * n_g + resident_col_ctas() - 1) / resident_col_ctas();
    const int gpc = static_cast<int>(per < 1 ? 1 : per);
    const dim3 grid(static_cast<unsigned>(row_blocks), static_cast<unsigned>((n_g + gpc - 1) / gpc));
    cols_kernel<T, Q><<<grid, kColThreads, 0, s>>>(x_, M, K, sk, q, gpc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace group_quant
