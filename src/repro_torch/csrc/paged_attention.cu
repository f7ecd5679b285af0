// GQA attention directly over the paged KV pool (packed MXFP4 or dense).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_paged_kernel, _online_softmax_tile, _load_kv_mxfp4, _load_kv_dense;
// entry paged_attention).  For slot b and KV head h the query block is the
// S·group rows r = s·group + g (query token s, head h·group + g); row r sees
// pool positions <= lengths[b] - 1 + r / group.  Pages are walked through
// the slot's page table; pages at or past lengths[b] + S - 1 are never read.
//
// Bound on H100: bytes.  At decode (S = 1) each KV byte feeds 2·group
// flops per element of Q·K and P·V — with the MXFP4 pool, 4.25 bits per
// element — far below the flops/byte ratio of the card.
//
// Design: one block of 4 warps per (16-row query tile, KV head, slot), so a
// decode step runs one tile per (slot, head) and a prefill chunk
// ceil(S·group / 16) tiles.  The block loops over its pages; each page's K
// and V are dequantized once into shared memory as f32 (nibble and E8M0
// codes unpacked with integer arithmetic, no table), then each warp folds
// the page into the online softmax (m, l, acc) of its rows, kept in f32
// registers: lane j scores key j against the row, the warp reduces max and
// sum, and each lane accumulates P·V for hd/32 dims.  Scores past a row's
// causal bound are set to -1e30 before the max, so a scratch or stale page
// entry never reaches the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;  // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxDimsPerLane = 4;  // hd <= 128
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4-bit E2M1 code (bit 3 = sign) → value; 2^((i-2)>>1)·(1 + (i&1)/2) for i >= 2
__device__ __forceinline__ float e2m1_value(int nib) {
  const int i = nib & 7;
  const float mag = i >= 2 ? __int_as_float((((i - 2) >> 1) + 127) << 23) * (1.f + 0.5f * (i & 1))
                           : 0.5f * i;
  return (nib & 8) ? -mag : mag;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, T* __restrict__ out, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vc,
    const uint8_t* __restrict__ vs, const T* __restrict__ kd, const T* __restrict__ vd,
    const int* __restrict__ tables, const int* __restrict__ lengths, int S, int Hq, int Hkv,
    int hd, int ps, int n_pp, float scale) {
  extern __shared__ float smem[];
  const int kpitch = hd + 1;
  float* Ks = smem;                 // [ps][hd + 1]
  float* Vs = Ks + ps * kpitch;     // [ps][hd]
  float* Qs = Vs + ps * hd;         // [kRows][hd], pre-scaled
  float* Ps = Qs + kRows * hd;      // [kWarps][32] softmax numerators

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv, R = S * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = tile * kRows;
  const int length = lengths[b];

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int rr = i / hd, d = i % hd, r = r0 + rr;
    float val = 0.f;
    if (r < R) {
      const long long row = (static_cast<long long>(b) * S + r / group) * Hq + h * group + r % group;
      val = to_f32(q[row * hd + d]) * scale;
    }
    Qs[i] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerLane; ++j) acc[i][j] = 0.f;
  }

  // pages p with p·ps < length + S - 1 hold every position some row may see
  int n_visit = (length + S - 1 + ps - 1) / ps;
  if (n_visit > n_pp) n_visit = n_pp;
  const int half = hd / 2, nscale = hd / 32;

  for (int p = 0; p < n_visit; ++p) {
    const long long page = tables[static_cast<long long>(b) * n_pp + p];
    __syncthreads();  // the previous page's tiles are no longer read
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const long long tok = (page * ps + t) * Hkv + h;
      float kv, vv;
      if (kPacked) {
        const int shift = (d & 1) ? 0 : 4;  // even element in the high nibble
        const int kn = (kc[tok * half + d / 2] >> shift) & 0xf;
        const int vn = (vc[tok * half + d / 2] >> shift) & 0xf;
        const float ksc = __int_as_float(static_cast<int>(ks[tok * nscale + d / 32]) << 23);
        const float vsc = __int_as_float(static_cast<int>(vs[tok * nscale + d / 32]) << 23);
        kv = e2m1_value(kn) * ksc;
        vv = e2m1_value(vn) * vsc;
      } else {
        kv = to_f32(kd[tok * hd + d]);
        vv = to_f32(vd[tok * hd + d]);
      }
      Ks[t * kpitch + d] = kv;
      Vs[t * hd + d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp + kWarps * i, r = r0 + rr;
      if (r >= R) continue;  // warp-uniform
      const int q_pos = length - 1 + r / group;
      float sc = kNegInf;
      if (lane < ps) {
        const float* qr = Qs + rr * hd;
        const float* kr = Ks + lane * kpitch;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        if (p * ps + lane <= q_pos) sc = dot;
      }
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float pj = lane < ps ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(pj);
      Ps[warp * 32 + lane] = pj;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kMaxDimsPerLane; ++j) {
        if (j < nscale) {
          const int d = lane + 32 * j;
          float a = acc[i][j] * corr;
          for (int t = 0; t < ps; ++t) a = fmaf(Ps[warp * 32 + t], Vs[t * hd + d], a);
          acc[i][j] = a;
        }
      }
      __syncwarp();
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    if (r >= R) continue;
    const long long row = (static_cast<long long>(b) * S + r / group) * Hq + h * group + r % group;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxDimsPerLane; ++j)
      if (j < nscale) store(out + row * hd + lane + 32 * j, acc[i][j] / denom);
  }
}

template <typename T>
int launch(const void* q, void* out, int packed, const void* kc, const void* ks,
           const void* vc, const void* vs, const void* kd, const void* vd, const void* tables,
           const void* lengths, int B, int S, int Hq, int Hkv, int hd, int ps, int n_pp,
           float scale, cudaStream_t stream) {
  const int R = S * (Hq / Hkv);
  const dim3 grid((R + kRows - 1) / kRows, Hkv, B);
  const size_t smem = sizeof(float) * (ps * (hd + 1) + ps * hd + kRows * hd + kWarps * 32);
  const auto* q_ = static_cast<const T*>(q);
  auto* o_ = static_cast<T*>(out);
  const auto* kc_ = static_cast<const uint8_t*>(kc);
  const auto* ks_ = static_cast<const uint8_t*>(ks);
  const auto* vc_ = static_cast<const uint8_t*>(vc);
  const auto* vs_ = static_cast<const uint8_t*>(vs);
  const auto* kd_ = static_cast<const T*>(kd);
  const auto* vd_ = static_cast<const T*>(vd);
  const auto* t_ = static_cast<const int*>(tables);
  const auto* l_ = static_cast<const int*>(lengths);
  if (packed) {
    paged_attention_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        q_, o_, kc_, ks_, vc_, vs_, kd_, vd_, t_, l_, S, Hq, Hkv, hd, ps, n_pp, scale);
  } else {
    paged_attention_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        q_, o_, kc_, ks_, vc_, vs_, kd_, vd_, t_, l_, S, Hq, Hkv, hd, ps, n_pp, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out [B, S, Hq, hd] contiguous (f32 or bf16); packed pool leaves
// [n_pages, ps, Hkv, hd/2] and [n_pages, ps, Hkv, hd/32] u8, or dense leaves
// [n_pages, ps, Hkv, hd] in q's dtype; tables [B, n_pp] and lengths [B] int32.
// Requires hd % 32 == 0, hd <= 128, ps <= 32.
extern "C" int paged_attention(const void* q, void* out, int is_bf16, int packed,
                               const void* kc, const void* ks, const void* vc, const void* vs,
                               const void* kd, const void* vd, const void* tables,
                               const void* lengths, int B, int S, int Hq, int Hkv, int hd,
                               int ps, int n_pp, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, out, packed, kc, ks, vc, vs, kd, vd, tables, lengths, B, S,
                                 Hq, Hkv, hd, ps, n_pp, scale, s);
  return launch<float>(q, out, packed, kc, ks, vc, vs, kd, vd, tables, lengths, B, S, Hq, Hkv,
                       hd, ps, n_pp, scale, s);
}
