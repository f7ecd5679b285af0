// MXFP4 block-scaled GEMM (Stage 2): f32 C[M, N] = A ⊗ SFA · B ⊗ SFB.
//
// Replaces the Pallas TPU kernel repro/kernels/mxfp4_matmul.py
// (_mxfp4_matmul_kernel, entry mxfp4_matmul).  Operands are int8
// half-codes (2 × E2M1 value) with one f32 power-of-two scale per 32
// elements along K: A codes [M, K] + scales [M, K/32], B codes [K, N] +
// scales [K/32, N], the value of a code being code · ½ · scale.
//
// Bound on H100: at decode (M = 8 rows) bytes — every B code (the weights,
// 1 B each) is read once and each byte is used by only M multiply-adds; at
// prefill (M = 512) the 2·M·N·K operations on the int8 path.
//
// Design: within one 32-group the scales are shared, so the group's partial
// product is an exact integer, Σ a·b over 32 half-codes (|Σ| ≤ 32·144), computed
// with 8 __dp4a per output.  Only the per-group terms
// isum · sa · sb · ¼ (exact: powers of two) are added in f32, in group
// order — the same order mxfp4_matmul_plain adds them, so the kernel and the
// plain version agree bit for bit.  Block tile BM x 64 x 32 (one group per
// k-step), 256 threads, each owning BM/16 x 4 outputs; BM = 16 when M <= 16
// so decode launches N/64 blocks instead of wasting 48 of 64 rows.  B is
// read through its strides: for the K-major view the weight path passes
// (the transpose of [N, K] codes) the load takes 4-byte words along K,
// otherwise single bytes along N — both coalesced, neither copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPitch = 36;  // bytes per smem row: 9 words, conflict-free reads

template <int BM>
__global__ void __launch_bounds__(kThreads) mxfp4_matmul_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ as, int M, int K,
    const int8_t* __restrict__ b, long long sbk, long long sbn, const float* __restrict__ bs,
    long long ssk, long long ssn, int N, bool b_kmajor, float* __restrict__ c) {
  __shared__ __align__(16) int8_t As[BM * kPitch];
  __shared__ __align__(16) int8_t Bs[kBN * kPitch];
  __shared__ float sA[BM];
  __shared__ float sB[kBN];
  constexpr int RM = BM / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int groups = K / kBK;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int k0 = g * kBK;
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i / 8, w = i % 8, m = m0 + r;
      const int val = m < M ? *reinterpret_cast<const int*>(a + static_cast<long long>(m) * K + k0 + 4 * w) : 0;
      *reinterpret_cast<int*>(As + r * kPitch + 4 * w) = val;
    }
    if (b_kmajor) {
      for (int i = tid; i < kBN * 8; i += kThreads) {
        const int n = i / 8, w = i % 8, nn = n0 + n;
        const int val = nn < N ? *reinterpret_cast<const int*>(b + static_cast<long long>(nn) * sbn + k0 + 4 * w) : 0;
        *reinterpret_cast<int*>(Bs + n * kPitch + 4 * w) = val;
      }
    } else {
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int kk = i / kBN, n = i % kBN, nn = n0 + n;
        Bs[n * kPitch + kk] = nn < N ? b[static_cast<long long>(k0 + kk) * sbk + static_cast<long long>(nn) * sbn] : 0;
      }
    }
    if (tid < BM) sA[tid] = m0 + tid < M ? as[static_cast<long long>(m0 + tid) * groups + g] : 0.f;
    if (tid >= 128 && tid < 128 + kBN) {
      const int n = tid - 128;
      sB[n] = n0 + n < N ? bs[static_cast<long long>(g) * ssk + static_cast<long long>(n0 + n) * ssn] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      int aw[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) aw[w] = *reinterpret_cast<const int*>(As + r * kPitch + 4 * w);
      const float sa = sA[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        int isum = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w)
          isum = __dp4a(aw[w], *reinterpret_cast<const int*>(Bs + n * kPitch + 4 * w), isum);
        const float term = __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(isum), sa), sB[n]), 0.25f);
        acc[i][j] = __fadd_rn(acc[i][j], term);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) c[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// a [M, K] int8 and as [M, K/32] f32, both contiguous; b [K, N] int8 and
// bs [K/32, N] f32 through element strides; c [M, N] f32 contiguous.
extern "C" int mxfp4_matmul(const void* a, const void* as, long long M, long long K,
                            const void* b, long long sbk, long long sbn, const void* bs,
                            long long ssk, long long ssn, long long N, void* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b_kmajor = sbk == 1 && sbn % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* asf = static_cast<const float*>(as);
  const auto* bsf = static_cast<const float*>(bs);
  auto* cf = static_cast<float*>(c);
  const unsigned gx = static_cast<unsigned>((N + kBN - 1) / kBN);
  if (M <= 16) {
    mxfp4_matmul_kernel<16><<<dim3(gx, static_cast<unsigned>((M + 15) / 16)), kThreads, 0, s>>>(
        a8, asf, static_cast<int>(M), static_cast<int>(K), b8, sbk, sbn, bsf, ssk, ssn,
        static_cast<int>(N), b_kmajor, cf);
  } else {
    mxfp4_matmul_kernel<64><<<dim3(gx, static_cast<unsigned>((M + 63) / 64)), kThreads, 0, s>>>(
        a8, asf, static_cast<int>(M), static_cast<int>(K), b8, sbk, sbn, bsf, ssk, ssn,
        static_cast<int>(N), b_kmajor, cf);
  }
  return static_cast<int>(cudaGetLastError());
}
