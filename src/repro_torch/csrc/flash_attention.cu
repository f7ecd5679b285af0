// Forward-only GQA flash attention, queries [B, S, Hq, hd] over keys and
// values [B, T, Hkv, hd], every operand read in place through its strides.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel; entries flash_attention and mha_flash).  Query row s of
// head h attends over key t of KV head h / (Hq / Hkv): scores
// (q·fl32(1/sqrt(hd)))·k in f32, masked to -1e30 for t >= T and, when
// causal, for t > s; online softmax (running max m, denominator l,
// numerator acc) over 64-key blocks, key blocks wholly in the future of a
// query block skipped; out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on H100: operations at the shapes of the evaluation path (S = T =
// 512, hd = 128: 4·S·T·hd flops, halved when causal, over 2 bytes per q, k,
// v and out element), bytes only for very short sequences.
//
// Design (a simple first kernel: f32 FMA on the CUDA cores, no tensor
// cores).  One block of 256 threads per (64-row query block, b·Hq + h).  The
// query tile is scaled once and kept transposed in shared memory as f32;
// each 64-key block of K (transposed) and V is staged in shared memory as
// f32, zero past T.  Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4·ty .. 4·ty + 3: it scores keys 4·tx .. 4·tx + 3 (a 4 x 4 register tile,
// two float4 shared loads per 16 FMAs), reduces the rows' max and sum
// across its 16-lane half-warp by __shfl_xor_sync, and accumulates P·V for
// the dims tx + 16·j (j < 8, so hd <= 128) from the probabilities written
// back to shared memory.  The mask value -1e30 is finite, so
// exp(m_prev - m_new) is 1, never NaN, while a row has seen only masked keys,
// and the first key block always holds a visible key for every causal row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// q/o [B, S, Hq, hd], k/v [B, T, Hkv, hd] of one dtype (f32 or bf16), the
// last axis contiguous; strides (in elements) for the batch, sequence and
// head axes of q, k, v and o, in that order, in st[12].  Requires
// hd <= 128 and Hq % Hkv == 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int is_bf16, int B, int Hq, int Hkv, int S, int T, int hd,
                               const long long* st, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T, hd, st, scale, causal, s);
  return launch<float>(q, k, v, o, B, Hq, Hkv, S, T, hd, st, scale, causal, s);
}
