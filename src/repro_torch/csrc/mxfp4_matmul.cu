// MXFP4 block-scaled GEMM (Stage 2): f32 C[M, N] = A ⊗ SFA · B ⊗ SFB, on
// Hopper's tensor cores (bf16 mma.sync m16n8k16, f32 accumulate) fed by a
// cp.async ring.
//
// Replaces the Pallas TPU kernel repro/kernels/mxfp4_matmul.py
// (_mxfp4_matmul_kernel, entry mxfp4_matmul).  Operands are int8
// half-codes (2 × E2M1 value) with one f32 power-of-two scale per 32
// elements along K: A codes [M, K] + scales [M, K/32], B codes [K, N] +
// scales [K/32, N], the value of a code being code · ½ · scale.  B is read
// K-major (element (k, n) at b + n·sbn + k): every call site passes the
// transposed view of [N, K] codes, and the wrapper raises on anything else.
//
// Bound on H100: at decode (M = 8 rows) bytes — every B code (the weights,
// 1 B each) is read once and each byte is used by only M multiply-adds; at
// prefill and in training the 2·M·N·K operations (counted at the int8
// tensor-core rate, the format's own).
//
// Design.  Each pipeline stage brings 4 consecutive 32-groups of the A and
// B code tiles (128 contiguous bytes per row, cp.async.cg 16 B, zero-filled
// past M, N and K) and their scales (cp.async 4 B) into a ring of STAGES
// slots in dynamic shared memory; the 16-B chunks of each row are
// XOR-swizzled by the row's low 3 bits, so ldmatrix reads of 8 rows at one
// column hit 8 distinct bank groups.  Each thread copies the same chunks
// and scales every stage, and one stage ahead turns the scales it copied
// into bf16 fold pairs (½·scale, −96·scale) in a small table, so the
// stage's one barrier (__syncthreads_or) also says whether any scale lies
// outside the folded range.  Per group, each warp reads its int8 fragments
// with ldmatrix (16 rows of A and 16 columns of B per x4) and dequantizes
// them in registers to bf16 with the scale folded in, code · ½ · scale (its
// rows' scales for A, its columns' for B): the half-codes have at most 2
// significant bits, so each value is exact in bf16, which has f32's
// exponent range.  The int8 → bf16 step is byte arithmetic: (c ^ 0x80) − 64
// per byte is c + 64 in [0, 127], the bf16 0x43·· with that mantissa is
// c + 192, and one bf16x2 FMA with −192·s' gives c·s' exactly.  A lane's 4
// codes k = 4t .. 4t + 3 of a 16-code slice become the fragment's k = 2t,
// 2t + 1, 2t + 8, 2t + 9, in A and B alike (a group's sum does not depend
// on the order of its terms).
//
// Why it stays bit-exact with mxfp4_matmul_plain, which adds
// isum · sa · sb · ¼ (isum = Σ of 32 code products, |isum| ≤ 32·144) to an
// f32 accumulator group by group.  Within one group every product of an
// (m, n) pair is a small integer times the same power of two sa·sb·¼, so
// the two m16n8k16 products of a group, the first into a zeroed fragment
// and the second taking the first's result as C, give that term exactly:
// every partial sum is an integer of at most 13 bits times one power of
// two.  Each group's term is then added to the running f32 accumulator with
// one __fadd_rn, in group order — the plain version's own addition.  The
// accumulator is never the MMA's C, no group is reordered and K is never
// split across CTAs.  This holds while every scale of the stage lies in
// [2^-60, 2^50] (or is 0, a zero-filled pad): the folded values are then
// normal bf16, their products normal f32 and the terms far from overflow.
// A stage with a scale outside (the E8M0 edges 2^-126 .. 2^127, the 2^-126
// of an all-zero group, NaN) converts its codes unscaled instead: the MMA
// then gives isum exactly, and the epilogue applies ((isum·sa)·sb)·¼ with
// the plain version's roundings (__fmul_rn, no contraction), so subnormal,
// overflowing and flushed cases round exactly as the plain version's do.
//
// Tiles.  M > 1024 (training): 128 x 128 CTA tiles, 8 warps of 64 x 32, 4
// stages.  16 < M <= 1024 (prefill): 64 x 128, 8 warps of 32 x 32, 4
// stages.  M <= 16 (decode): 16 x 32, 2 warps of 16 x 16, 8 stages, so a
// 2048-wide projection launches 64 CTAs and each keeps 28 KB of weight
// bytes in flight (decode is bound by those bytes).
//
// The expert axis (mxfp4_matmul_experts): E independent products
// C[e] = A[e] · B[e], f32 [E, M, N], as a MoE layer's expert linear gives
// them (the dispatched tokens' codes [E, c, D] against each expert's weight
// codes, K-major per expert).  One launch, the expert on blockIdx.z: each
// CTA moves its pointers to its expert's operands at their expert strides
// and runs the 2-d body unchanged, tiles chosen by M as above, so C[e] is
// bit for bit a 2-d launch's.  It replaces the vmapped Pallas call of the
// reference's MoE (repro/models/moe.py, _expert_ffn).
//
// Hazards.  Hopper's bf16 MMA on subnormal operands never arises on the
// folded path (those stages take the unscaled one).  Two bf16 products per
// 32-group cost 2·M·N·K tensor-core operations at half the int8 rate, and
// each warp converts its own fragments (A rows are converted by the 4
// warps that share them); the int8 m16n8k32 route would give isum exactly
// with no conversion, but needs a conversion and a scale product per
// output per group on the CUDA cores, where the folded route needs one add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr float kSafeMin = 0x1p-60f;
constexpr float kSafeMax = 0x1p50f;

using namespace sm90;

// two codes (bytes c + 64 of t picked by sel) → bf16x2 of c·s, exactly
__device__ __forceinline__ uint32_t fold2(uint32_t t, uint32_t sel, __nv_bfloat162 s,
                                          __nv_bfloat162 nb) {
  uint32_t v = __byte_perm(t, 0x43434343u, sel);
  __nv_bfloat162 r = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&v), s, nb);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ bool safe_scale(float s) {
  return s == 0.f || (s >= kSafeMin && s <= kSafeMax);
}

constexpr int GPS = 4;  // 32-groups per pipeline stage: 128 code bytes a row

template <int BM, int BN>
struct Layout {
  static constexpr int KB = 32 * GPS;  // code bytes per row per stage
  static constexpr int kRows = BM + BN;
  static constexpr int kStage = kRows * KB + kRows * GPS * 4;  // codes, then f32 scales
  static constexpr int kFolds = kRows * GPS * 8;               // a Fold per (row, group)
  static constexpr int kFoldSets = 3;  // being written, being read, last read
  static constexpr size_t bytes(int stages) {
    return static_cast<size_t>(stages) * kStage + kFoldSets * kFolds;
  }
};

// byte offset of 16-B chunk ch of code row r (128 B a row), the chunk index
// XOR-swizzled by the row's low 3 bits
__device__ __forceinline__ int swz(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

struct Fold {
  __nv_bfloat162 s, nb;  // ½·scale and −96·scale = −192·(½·scale)
};

__device__ __forceinline__ Fold fold_of(float s) {
  return {__float2bfloat162_rn(0.5f * s), __float2bfloat162_rn(-96.f * s)};
}

// 4 codes (one word, k = 4t .. 4t + 3 of a 16-code slice) → bf16x2 of
// codes 0, 1 (the fragment's k = 2t, 2t + 1) and of codes 2, 3 (its
// k = 2t + 8, 2t + 9), times the fold.  A and B take the same k order, and
// a group's sum does not depend on its order.
__device__ __forceinline__ void cvt4(uint32_t w, const Fold& f, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = (w ^ 0x80808080u) - 0x40404040u;
  lo = fold2(t, 0x4140, f.s, f.nb);
  hi = fold2(t, 0x4342, f.s, f.nb);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32) mxfp4_mma_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ as, int M, int K,
    const int8_t* __restrict__ b, long long sbn, const float* __restrict__ bs, long long ssk,
    long long ssn, int N, float* __restrict__ c, long long sae, long long sase, long long sbe,
    long long sbse) {
  using L = Layout<BM, BN>;
  {  // expert blockIdx.z's operands (all strides 0 for a 2-d product)
    const long long e = blockIdx.z;
    a += e * sae;
    as += e * sase;
    b += e * sbe;
    bs += e * sbse;
    c += e * M * static_cast<long long>(N);
  }
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int KB = L::KB;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MF = WM / 16, NF = WN / 8;
  constexpr int CPR = KB / 16;     // 16-B code chunks per row per stage
  constexpr int RSTEP = NT / CPR;  // code rows per load pass
  constexpr int SSTEP = NT / GPS;  // scale rows per load pass
  static_assert(MF >= 1 && NF % 2 == 0 && KB == 128 && STAGES >= 3, "tile shape");
  static_assert(BM % RSTEP == 0 && BN % RSTEP == 0 && BM % SSTEP == 0 && BN % SSTEP == 0,
                "load passes");

  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = K / 32;
  const int n_stages = (G + GPS - 1) / GPS;

  auto codes_of = [&](int slot) { return smem + slot * L::kStage; };
  auto scales_of = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * L::kStage + L::kRows * KB);
  };
  auto folds_of = [&](int st) {
    return reinterpret_cast<uint2*>(smem + STAGES * L::kStage +
                                    (st % L::kFoldSets) * L::kFolds);
  };

  // each thread copies code chunk lch of rows lr + k·RSTEP and scale lsj of
  // rows lsr + k·SSTEP, the same ones every stage
  const int lch = tid % CPR, lr = tid / CPR, lsj = tid % GPS, lsr = tid / GPS;
  const int8_t* a_src = a + static_cast<long long>(m0 + lr) * K + lch * 16;
  const int8_t* b_src = b + static_cast<long long>(n0 + lr) * sbn + lch * 16;
  const float* as_src = as + static_cast<long long>(m0 + lsr) * G + lsj;
  const float* bs_src =
      bs + static_cast<long long>(lsj) * ssk + static_cast<long long>(n0 + lsr) * ssn;

  auto load_stage = [&](int st, int slot) {
    uint8_t* cs = codes_of(slot);
    float* ss = scales_of(slot);
    const bool kvalid = st * KB + lch * 16 < K;
#pragma unroll
    for (int k = 0; k < BM / RSTEP; ++k) {
      const bool valid = kvalid && m0 + lr + k * RSTEP < M;
      cp_async16(cs + swz(lr + k * RSTEP, lch),
                 valid ? a_src + static_cast<long long>(k * RSTEP) * K + st * KB : a, valid);
    }
#pragma unroll
    for (int k = 0; k < BN / RSTEP; ++k) {
      const bool valid = kvalid && n0 + lr + k * RSTEP < N;
      cp_async16(cs + swz(BM + lr + k * RSTEP, lch),
                 valid ? b_src + static_cast<long long>(k * RSTEP) * sbn + st * KB : b, valid);
    }
    const bool gvalid = st * GPS + lsj < G;
#pragma unroll
    for (int k = 0; k < BM / SSTEP; ++k) {
      const bool valid = gvalid && m0 + lsr + k * SSTEP < M;
      cp_async4(ss + (lsr + k * SSTEP) * GPS + lsj,
                valid ? as_src + static_cast<long long>(k * SSTEP) * G + st * GPS : as, valid);
    }
#pragma unroll
    for (int k = 0; k < BN / SSTEP; ++k) {
      const bool valid = gvalid && n0 + lsr + k * SSTEP < N;
      cp_async4(ss + (BM + lsr + k * SSTEP) * GPS + lsj,
                valid ? bs_src + static_cast<long long>(k * SSTEP) * ssn +
                            static_cast<long long>(st * GPS) * ssk
                      : bs,
                valid);
    }
  };

  // the scales this thread copied for stage st (visible to it once its
  // copies have landed) → their Folds; returns whether one lies outside
  // the folded range
  auto fold_stage = [&](int st) {
    const float* ss = scales_of(st % STAGES);
    uint2* ft = folds_of(st);
    bool bad = false;
#pragma unroll
    for (int k = 0; k < L::kRows / SSTEP; ++k) {
      const int i = (lsr + k * SSTEP) * GPS + lsj;
      const float sc = ss[i];
      bad |= !safe_scale(sc);
      const Fold f = fold_of(sc);
      ft[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&f.s),
                         *reinterpret_cast<const uint32_t*>(&f.nb));
    }
    return bad;
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const Fold unscaled = fold_of(2.f);  // ½·s = 1: the bare half-codes

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  bool bad_next = fold_stage(0);

  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % STAGES;
    bool bad = bad_next;
    cp_async_wait<STAGES - 3>();  // stages st and st + 1 have landed
    if (st + 1 < n_stages) bad_next = fold_stage(st + 1);
    // stage st's codes and Folds visible to all; stage st - 1 no longer read
    const bool unsafe = __syncthreads_or(bad) != 0;
    {
      const int nx = st + STAGES - 1;
      if (nx < n_stages) load_stage(nx, nx % STAGES);
      cp_async_commit();
    }
    const uint8_t* cs = codes_of(slot);
    const float* ss = scales_of(slot);
    const uint2* ft = folds_of(st);

#pragma unroll
    for (int gi = 0; gi < GPS; ++gi) {
      if (st * GPS + gi >= G) break;
      // the Folds of this lane's fragment rows (A: g and g + 8 of each m16
      // tile) and columns (B: g of each n8 tile); a stage with a scale
      // outside the folded range runs unscaled
      Fold fa[MF][2], fb[NF];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 v = ft[(wm * WM + mf * 16 + (lane >> 2) + 8 * h) * GPS + gi];
          fa[mf][h] = unsafe ? unscaled : *reinterpret_cast<const Fold*>(&v);
        }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const uint2 v = ft[(BM + wn * WN + nf * 8 + (lane >> 2)) * GPS + gi];
        fb[nf] = unsafe ? unscaled : *reinterpret_cast<const Fold*>(&v);
      }

      // int8 fragments of the group: per 16-row A tile, rows g / g + 8 of
      // code slices 0 (k 0..15) and 1 (k 16..31); per n8 B tile, column g
      uint32_t ra[MF][4], rb[NF][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        ldmatrix_x4(ra[mf], cs + swz(wm * WM + mf * 16 + (lane & 15), 2 * gi + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t t[4];
        ldmatrix_x4(t, cs + swz(BM + wn * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * gi + ((lane >> 3) & 1)));
        rb[2 * np][0] = t[0];
        rb[2 * np][1] = t[1];
        rb[2 * np + 1][0] = t[2];
        rb[2 * np + 1][1] = t[3];
      }

      float d[MF][NF][4];
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        uint32_t af[MF][4], bfr[NF][2];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          cvt4(ra[mf][2 * sl], fa[mf][0], af[mf][0], af[mf][2]);
          cvt4(ra[mf][2 * sl + 1], fa[mf][1], af[mf][1], af[mf][3]);
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) cvt4(rb[nf][sl], fb[nf], bfr[nf][0], bfr[nf][1]);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            if (sl == 0)  // a fresh sum per group: never the running accumulator
              mma_bf16(d[mf][nf], af[mf], bfr[nf][0], bfr[nf][1], zero);
            else
              mma_bf16(d[mf][nf], af[mf], bfr[nf][0], bfr[nf][1], d[mf][nf]);
          }
      }
      if (!unsafe) {
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mf][nf][e] = __fadd_rn(acc[mf][nf][e], d[mf][nf][e]);
      } else {
        // d holds isum exactly: the plain version's ((isum·sa)·sb)·¼ with
        // the scales of this lane's accumulator rows and columns
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const int r = wm * WM + mf * 16 + (lane >> 2);
          const float sa[2] = {ss[r * GPS + gi], ss[(r + 8) * GPS + gi]};
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const int n = BM + wn * WN + nf * 8 + 2 * (lane & 3);
            const float sb[2] = {ss[n * GPS + gi], ss[(n + 1) * GPS + gi]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float term = __fmul_rn(
                  __fmul_rn(__fmul_rn(d[mf][nf][e], sa[e >> 1]), sb[e & 1]), 0.25f);
              acc[mf][nf][e] = __fadd_rn(acc[mf][nf][e], term);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mf * 16 + (lane >> 2) + 8 * h;
      if (m >= M) continue;
      float* crow = c + static_cast<long long>(m) * N;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int n = n0 + wn * WN + nf * 8 + 2 * (lane & 3);
        const float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(crow + n) = make_float2(v0, v1);
        } else {
          if (n < N) crow[n] = v0;
          if (n + 1 < N) crow[n + 1] = v1;
        }
      }
    }
}

// expert strides of A, its scales, B and its scales (elements)
struct ExpertStrides {
  long long E, a, as, b, bs;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
int launch(const int8_t* a, const float* as, int M, int K, const int8_t* b, long long sbn,
           const float* bs, long long ssk, long long ssn, int N, float* c,
           const ExpertStrides& ex, cudaStream_t s) {
  auto kernel = mxfp4_mma_kernel<BM, BN, WARPS_M, WARPS_N, STAGES>;
  constexpr size_t smem = Layout<BM, BN>::bytes(STAGES);
  static int ready_device = -1;  // the dynamic shared-memory limit is set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != ready_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready_device = dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, static_cast<unsigned>(ex.E));
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, s>>>(a, as, M, K, b, sbn, bs, ssk, ssn, N, c,
                                                    ex.a, ex.as, ex.b, ex.bs);
  return static_cast<int>(cudaGetLastError());
}

// the M-bucketed tiles: decode (M <= 16), prefill (M <= 1024), training
int dispatch(const void* a, const void* as, long long M, long long K, const void* b,
             long long sbn, const void* bs, long long ssk, long long ssn, long long N, void* c,
             const ExpertStrides& ex, cudaStream_t s) {
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* asf = static_cast<const float*>(as);
  const auto* bsf = static_cast<const float*>(bs);
  auto* cf = static_cast<float*>(c);
  const int m = static_cast<int>(M), k = static_cast<int>(K), n = static_cast<int>(N);
  if (M <= 16)
    return launch<16, 32, 1, 2, 8>(a8, asf, m, k, b8, sbn, bsf, ssk, ssn, n, cf, ex, s);
  if (M <= 1024)
    return launch<64, 128, 2, 4, 4>(a8, asf, m, k, b8, sbn, bsf, ssk, ssn, n, cf, ex, s);
  return launch<128, 128, 2, 4, 4>(a8, asf, m, k, b8, sbn, bsf, ssk, ssn, n, cf, ex, s);
}

}  // namespace

// a [M, K] int8 and as [M, K/32] f32, both contiguous, a 16-B aligned; b
// [K, N] int8 K-major (element (k, n) at b + n·sbn + k, b and sbn 16-B
// aligned) and bs [K/32, N] f32 through element strides; c [M, N] f32
// contiguous; K % 32 == 0.
extern "C" int mxfp4_matmul(const void* a, const void* as, long long M, long long K,
                            const void* b, long long sbn, const void* bs, long long ssk,
                            long long ssn, long long N, void* c, void* stream) {
  return dispatch(a, as, M, K, b, sbn, bs, ssk, ssn, N, c, ExpertStrides{1, 0, 0, 0, 0},
                  static_cast<cudaStream_t>(stream));
}

// The expert axis: E products in one launch.  Expert e's A is a + e·sae
// ([M, K], contiguous rows of K), its scales as + e·sase ([M, K/32]), its B
// b + e·sbe (K-major as above; sbe a multiple of 16), its B scales bs +
// e·sbse (strides ssk, ssn), and its C c + e·M·N; c [E, M, N] contiguous.
extern "C" int mxfp4_matmul_experts(const void* a, const void* as, long long E, long long M,
                                    long long K, long long sae, long long sase, const void* b,
                                    long long sbn, long long sbe, const void* bs, long long ssk,
                                    long long ssn, long long sbse, long long N, void* c,
                                    void* stream) {
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(a, as, M, K, b, sbn, bs, ssk, ssn, N, c, ExpertStrides{E, sae, sase, sbe, sbse},
                  static_cast<cudaStream_t>(stream));
}
