// Forward-only GQA flash attention, queries [B, S, Hq, hd] over keys and
// values [B, T, Hkv, hd], every operand read in place through its strides.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel; entries flash_attention and mha_flash).  Query row s of
// head h attends over key t of KV head h / (Hq / Hkv): scores
// q·k·fl32(1/sqrt(hd)) in f32, masked to -1e30 for t >= T and, when
// causal, for t > s; online softmax (running max m, denominator l,
// numerator acc) over 64-key blocks, key blocks wholly in the future of a
// query block skipped; out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on H100: at the evaluation shape (16 x 512, 10 heads of 128,
// causal, bf16) the bytes, 2 per q, k, v and out element; at long
// sequences (qwen3-1.7b's GQA at 4096) the 4·S·T·hd flops, halved when
// causal, at the bf16 tensor-core rate.
//
// Two bodies.  bf16 operands with hd in {64, 128} and 16-byte aligned rows
// (every bf16 call of the evaluation path) take flash_mma_kernel, FA2-style
// on the tensor cores; f32 operands, other head sizes and unaligned views
// take flash_kernel, f32 FMA on the CUDA cores (its f32 results hold the
// checks at atol 2e-5).
//
// flash_mma_kernel: one CTA of 4 warps per (64-row query block, b·Hq + h),
// the query blocks on the slow grid axis with the longest (causal: the
// last) first; each warp owns 16 query rows, whose Q fragments it loads
// once with ldmatrix and keeps in registers for the whole key loop.  64-key
// K and V tiles (bf16, zero-filled past T) stream through a 2-stage
// cp.async ring in dynamic shared memory, the next block's copy in flight
// while the current one is used; the 16-byte chunks of every tile row are
// XOR-swizzled by the row's low 3 bits so that ldmatrix reads are
// conflict-free.  Per key block: S = Q·Kᵀ by mma.sync m16n8k16 (bf16 in,
// f32 accumulate), left unscaled; masks only where a warp's rows meet the
// ragged key edge or the causal diagonal; row max (of unscaled scores) and
// row sum by quad shuffles on the accumulator fragments; p = exp(s·scale −
// m·scale) in f32 as 2^(s·c − m·c), c = scale·log2 e, one FFMA and one
// MUFU ex2 per score (the plain version scales q first and calls exp:
// ~1e-6 apart relative); then P·V with the accumulator layout of S reused
// directly as the A fragments and V read by ldmatrix.trans.
//
// Why P is split.  P is an f32 probability, and the tensor core takes
// bf16.  Rounded once, P carries a relative error of 2^-9, which an output
// near zero (a sum of terms of both signs) shows at full size against the
// f32 plain version.  So each P fragment is split into hi = bf16(p) and
// lo = bf16(p - hi) and both products are issued: about 16 bits of P,
// 1.5x the MMA work of one product.  That keeps the bf16 check (|Δ| <=
// 1e-5 + 2^-7·|plain|) as it is.
//
// Hazards.  Register pressure: a warp holds 16 x hd f32 accumulators, its
// Q fragments, 16 x 64 scores and the hi/lo P fragments (the build prints
// -Xptxas -v; spills must stay 0).  hd = 64 runs the same code with half
// the fragments.  The mask value -1e30 is finite, so exp(m_prev - m_new)
// is 1, never NaN, while a row has seen only masked keys, and the first key
// block always holds a visible key for every causal row.
//
// flash_kernel (unchanged): one block of 256 threads per (64-row query
// block, b·Hq + h).  The query tile is scaled once and kept transposed in
// shared memory as f32; each 64-key block of K (transposed) and V is staged
// in shared memory as f32, zero past T.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns query rows 4·ty .. 4·ty + 3: it scores keys 4·tx .. 4·tx
// + 3 (a 4 x 4 register tile), reduces the rows' max and sum across its
// 16-lane half-warp by __shfl_xor_sync, and accumulates P·V for the dims
// tx + 16·j (j < 8, so hd <= 128) from the probabilities written back to
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxDimsPerThread = 8;  // hd <= 128 over 16 column threads
constexpr int kPitch = 68;  // row pitch of the transposed tiles: float4-aligned
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * hd * kPitch + kBlockK * hd + kBlockQ * kPitch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int S, int T_, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [hd][kPitch]   q·scale, transposed
  float* Kt = Qt + hd * kPitch;      // [hd][kPitch]   k, transposed
  float* Vs = Kt + hd * kPitch;      // [kBlockK][hd]
  float* Ps = Vs + kBlockK * hd;     // [kBlockQ][kPitch] probabilities

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = q0 + r;
    Qt[d * kPitch + r] = s < S ? __fmul_rn(to_f32(qp[s * qss + d]), scale) : 0.f;
  }

  float m[4], l[4], acc[4][kMaxDimsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerThread; ++j) acc[i][j] = 0.f;
  }

  int n_kb = (T_ + kBlockK - 1) / kBlockK;
  if (causal) n_kb = min(n_kb, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous block's tiles are no longer read
    for (int i = tid; i < kBlockK * hd; i += kThreads) {
      const int c = i / hd, d = i % hd, t = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (t < T_) {
        kv = to_f32(kp[t * kss + d]);
        vv = to_f32(vp[t * vss + d]);
      }
      Kt[d * kPitch + c] = kv;
      Vs[c * hd + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kPitch + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * kPitch + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + 4 * tx + j;
        if (k_pos >= T_ || (causal && q_pos < k_pos)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(sc[i][j] - m_new);
        sum += p[j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxDimsPerThread; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(Ps + (4 * ty + i) * kPitch + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * kPitch + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = Vs + (c + cc) * hd;
#pragma unroll
        for (int j = 0; j < kMaxDimsPerThread; ++j) {
          const int d = tx + 16 * j;
          if (d < hd) {
            const float vv = vr[d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pv = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
              acc[i][j] = fmaf(pv, vv, acc[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + h * osh + s * oss;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(orow + d, acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
           int T_, int hd, const long long* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_mma_kernel: bf16 on the tensor cores (hd in {64, 128})
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kBlockQ

using namespace sm90;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) → hi = bf16(x, y), lo = bf16(x - hi, y - hi): about 16 bits of each
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x (MUFU; relative error ~2^-22, 0 for x far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// byte offset of 16-B chunk ch of row r in a 64-row tile of HD bf16 a row,
// the chunk index XOR-swizzled by the row's low 3 bits
template <int HD>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * (HD * 2) + ((ch ^ (r & 7)) << 4);
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kBlockQ + 2 * 2 * kBlockK) * HD * 2;  // Q, then 2 x (K, V)
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S,
    int T_, long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, int causal) {
  constexpr int CH = HD / 8;   // 16-B chunks per row
  constexpr int KF = HD / 16;  // k16 slices of a Q row; pairs of 8-wide d tiles of V
  constexpr int kTile = kBlockK * HD * 2;
  static_assert(kBlockQ == kBlockK && kBlockQ == 16 * (kMmaThreads / 32), "tile shape");
  extern __shared__ __align__(128) uint8_t smem_mma[];
  uint8_t* Qs = smem_mma;  // stage j: K at Qs + kTile·(1 + 2j), V right after it

  // query blocks on the slow grid axis, the longest (causal: the last) first
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qp = q + b * qsb + h * qsh;
  const __nv_bfloat16* kp = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vp = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBlockQ * CH; i += kMmaThreads) {
    const int r = i / CH, ch = i % CH, s = q0 + r;
    const bool ok = s < S;
    cp_async16(Qs + swz<HD>(r, ch), ok ? qp + s * qss + ch * 8 : qp, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int kb, int stage) {
    uint8_t* Ks = Qs + kTile * (1 + 2 * stage);
    uint8_t* Vs = Ks + kTile;
    for (int i = tid; i < kBlockK * CH; i += kMmaThreads) {
      const int r = i / CH, ch = i % CH, t = kb * kBlockK + r;
      const bool ok = t < T_;
      cp_async16(Ks + swz<HD>(r, ch), ok ? kp + t * kss + ch * 8 : kp, ok);
      cp_async16(Vs + swz<HD>(r, ch), ok ? vp + t * vss + ch * 8 : vp, ok);
    }
  };

  int n_kb = (T_ + kBlockK - 1) / kBlockK;
  if (causal) n_kb = min(n_kb, (q0 + kBlockQ - 1) / kBlockK + 1);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; K/V block 0 may still be in flight
  __syncthreads();
  uint32_t qf[KF][4];
#pragma unroll
  for (int kk = 0; kk < KF; ++kk)
    ldmatrix_x4(qf[kk], Qs + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  // this thread's two rows: accumulator elements 0, 1 (row_lo) and 2, 3 (+8)
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  // scores stay unscaled q·k; exp(x·scale) = 2^(x·c).  m is a running max
  // of unscaled scores
  const float c = scale * 1.4426950408889634f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    if (kb + 1 < n_kb) load_kv(kb + 1, (kb + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // block kb has landed
    __syncthreads();
    const uint8_t* Ks = Qs + kTile * (1 + 2 * (kb & 1));
    const uint8_t* Vs = Ks + kTile;

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KF; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t t[4];
        ldmatrix_x4(t, Ks + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], qf[kk], t[0], t[1], sc[2 * np]);
        mma_bf16(sc[2 * np + 1], qf[kk], t[2], t[3], sc[2 * np + 1]);
      }

    // masks only where this warp's rows meet a ragged key edge or the
    // causal diagonal
    const int k0 = kb * kBlockK;
    if (k0 + kBlockK > T_ || (causal && k0 + kBlockK - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const int q_pos = row_lo + 8 * (e >> 1);
          if (k_pos >= T_ || (causal && q_pos < k_pos)) sc[nt][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    float corr[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      corr[i] = ex2((m_r[i] - m_new) * c);
      m_r[i] = m_new;
      mc[i] = m_new * c;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[nt][e], c, -mc[e >> 1]));
        sc[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] *= corr[e >> 1];

    // P·V: the score tiles 2kc, 2kc + 1 are the A fragment of key slice kc
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KF; ++dp) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, Vs + swz<HD>(kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                          2 * dp + (lane >> 4)));
        mma_bf16(oacc[2 * dp], ph, t[0], t[1], oacc[2 * dp]);
        mma_bf16(oacc[2 * dp], pl, t[0], t[1], oacc[2 * dp]);
        mma_bf16(oacc[2 * dp + 1], ph, t[2], t[3], oacc[2 * dp + 1]);
        mma_bf16(oacc[2 * dp + 1], pl, t[2], t[3], oacc[2 * dp + 1]);
      }
    }
    __syncthreads();  // the stage is free for block kb + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row_lo + 8 * i;
    if (s >= S) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = o + b * osb + h * osh + s * oss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(oacc[j][2 * i] / denom, oacc[j][2 * i + 1] / denom);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
               int S, int T_, const long long* st, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  static int ready_device = -1;  // the dynamic shared-memory limit is set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != ready_device) {
    err = cudaFuncSetAttribute(flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready_device = dev;
  }
  const dim3 grid(B * Hq, (S + kBlockQ - 1) / kBlockQ);
  flash_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, T_,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// every operand 16-byte aligned and every strided row a whole number of
// 16-byte chunks: what cp.async of 16 B takes
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const long long* st) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (ptrs & 15) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

}  // namespace

// q/o [B, S, Hq, hd], k/v [B, T, Hkv, hd] of one dtype (f32 or bf16), the
// last axis contiguous; strides (in elements) for the batch, sequence and
// head axes of q, k, v and o, in that order, in st[12].  Requires
// hd <= 128 and Hq % Hkv == 0.  bf16 at hd 64 or 128 with aligned rows runs
// on the tensor cores, everything else on the FMA body.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int is_bf16, int B, int Hq, int Hkv, int S, int T, int hd,
                               const long long* st, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && (hd == 64 || hd == 128) && mma_aligned(q, k, v, o, st))
    return hd == 64 ? launch_mma<64>(q, k, v, o, B, Hq, Hkv, S, T, st, scale, causal, s)
                    : launch_mma<128>(q, k, v, o, B, Hq, Hkv, S, T, st, scale, causal, s);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T, hd, st, scale, causal, s);
  return launch<float>(q, k, v, o, B, Hq, Hkv, S, T, hd, st, scale, causal, s);
}
