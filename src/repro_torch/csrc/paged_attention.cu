// GQA attention directly over the paged KV pool (packed MXFP4 or dense).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_paged_kernel, _online_softmax_tile, _load_kv_mxfp4, _load_kv_dense;
// entry paged_attention).  For slot b and KV head h the query block is the
// S·group rows r = s·group + g (query token s, head h·group + g); row r sees
// pool positions <= lengths[b] - 1 + r / group.  Pages are walked through
// the slot's page table; pages at or past lengths[b] + S - 1 (and table
// columns past n_pp) are never read.
//
// Bound on H100: bytes.  At decode (S = 1) each KV byte feeds 2·group
// flops per element of Q·K and P·V — with the MXFP4 pool, 4.25 bits per
// element — far below the flops/byte ratio of the card.  The work of one
// layer is small (a few MB), so what the kernel can win is parallelism and
// short dependent chains, not bandwidth.
//
// Two bodies.  bf16 queries with hd in {64, 128}, a page size dividing 64
// and aligned operands (every call of the qwen3-1.7b engine) take
// paged_mma_kernel, flash-decoding on the tensor cores; f32 queries and
// other shapes take paged_attention_kernel, f32 FMA on the CUDA cores (the
// first design, below; its f32 results hold the checks at atol 2e-5).
//
// paged_mma_kernel.  The visible pages of each (slot, KV head) are cut into
// chunks of nb sub-blocks of 64 keys, and each chunk gets its own CTA of 4
// warps: grid (chunk, query tile, slot·Hkv), sized from n_pp (the table
// width), never from lengths, so the host never reads them.  nb grows with
// the table so that there are at most kMaxChunks chunks: the combine's
// table of partials then fits in the body's shared memory at any width.  A
// CTA whose chunk starts at or past n_visit = min(ceil((len + S - 1) / ps),
// n_pp) exits at once, except chunk 0, which always runs so that every row
// gets an output.  The warps split as WR query tiles of 16 rows x WK key
// parts (WR·WK = 4): at decode (S·group <= 16 rows) one 16-row tile and
// four 16-key parts, above that four 16-row tiles and one 64-key part.
//   Load: every copy of the chunk is issued at once (cp.async of 16 B: the
//   query tile, and K and V codes or dense bf16 rows; plain loads of the
//   E8M0 scale bytes); several CTAs on each SM overlap one chunk's loads
//   with another's products, in place of a page-by-page ring.  Packed codes
//   are dequantized straight to bf16 (E2M1 x 2^e is exact in bf16, also for
//   subnormal scales) into XOR-swizzled K and V tiles, as B6 keeps them.
//   Products: S = Q·Kᵀ by mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//   the query tile as given, unscaled; masked (position past the row's
//   causal bound, or page at or past n_visit) to p = 0; p = 2^(s·c − m·c)
//   with c = scale·log2 e and m the max of the visible scores; P·V with P
//   split into bf16 hi + lo halves, both products issued (P rounded once to
//   bf16 fails the bf16 check, tests/test_torch_kernels.py), as B6 does.
//   Partial: each warp writes its (m·c, l, acc[hd]) in f32 for each of its
//   rows to the wrapper's scratch buffer as split chunk·WK + part (l = 0:
//   no visible key).
//   Combine, in the same launch: after a fence, thread 0 takes a ticket on
//   the (slot, head, tile)'s counter; the CTA that draws the last one reads
//   every split of its rows (through L2), takes M = max of m over splits
//   with l > 0, weights w = 2^(m − M) (0 where l = 0; such a split's acc is
//   0), L = Σ l·w and out = Σ w·acc / max(L, 1e-30), each sum in chunk
//   order, writes bf16, and resets the counter to
//   0, so the counter buffer is reused without a memset.  A row that sees
//   no key gets 0, as in the FMA body.
//
// Hazards.  Rows past the table (the batched prefill's padding rows, whose
// bound passes n_pp·ps) see exactly the keys on table columns < n_visit.
// Scale codes 1 and 2 give subnormal bf16 operands, which the tensor core
// may flush (values near 1e-38, below the bf16 check's atol).  Registers:
// 64 accumulators, 32 Q registers and up to 32 scores a thread at hd 128
// (the build prints -Xptxas -v; spills must stay 0).
//
// paged_attention_kernel: one block of 4 warps per (16-row
// query tile, KV head, slot).  The block loops over its pages; each page's
// K and V are dequantized once into shared memory as f32 (nibble and E8M0
// codes unpacked with integer arithmetic, no table), then each warp folds
// the page into the online softmax (m, l, acc) of its rows, kept in f32
// registers: lane j scores key j against the row, the warp reduces max and
// sum, and each lane accumulates P·V for hd/32 dims.  Scores past a row's
// causal bound are set to -1e30 before the max, so a scratch or stale page
// entry never reaches the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

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
__global__ void __launch_bounds__(kThreads, 1) paged_attention_kernel(
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

// ---------------------------------------------------------------------------
// paged_mma_kernel: bf16 queries, split over CTAs, on the tensor cores
// ---------------------------------------------------------------------------

using namespace sm90;

constexpr int kChunk = 64;      // keys per sub-block
constexpr int kMaxChunks = 32;  // chunks per (slot, head, tile) at most

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) → hi = bf16(x, y), lo = bf16(x - hi, y - hi): about 16 bits of each
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hv);
  hi = bits(hv);
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

// byte offset of 16-B chunk ch of row r in a tile of HD bf16 a row, the
// chunk index XOR-swizzled by the row's low 3 bits (conflict-free ldmatrix)
template <int HD>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * (HD * 2) + ((ch ^ (r & 7)) << 4);
}

// 8 E2M1 codes (4 bytes, the even element in each byte's high nibble) times
// the scale 2^(code - 127), as 8 bf16 (exact)
__device__ __forceinline__ uint4 dequant8(uint32_t w, int scale_code) {
  const float sc = __int_as_float(scale_code << 23);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int byte = (w >> (8 * j)) & 0xff;
    o[j] = bits(__floats2bfloat162_rn(e2m1_value(byte >> 4) * sc, e2m1_value(byte & 0xf) * sc));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <int HD, int WK, bool kPacked>
struct MmaLayout {
  static constexpr int WR = kWarps / WK;        // 16-row query tiles per CTA
  static constexpr int RT = 16 * WR;            // query rows per CTA
  static constexpr int kTile = kChunk * HD * 2; // one bf16 K or V tile of 64 keys
  static constexpr int kQ = RT * HD * 2;
  static constexpr int kCodes = kChunk * HD / 2;  // one raw code tile
  // packed: the bf16 K and V tiles, then two stages of raw K and V codes;
  // dense: two stages of bf16 K and V tiles, copied in as they are
  static constexpr int kStage = kPacked ? 2 * kCodes : 2 * kTile;
  static constexpr int kScales = kChunk * HD / 32;  // packed: K then V scale bytes
  static constexpr int bytes() {
    return kQ + (kPacked ? 2 * kTile + 2 * kStage + 2 * kScales : 2 * kStage);
  }
};

template <int HD, int WK, bool kPacked>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const uint8_t* __restrict__ kc, const uint8_t* __restrict__ ks,
    const uint8_t* __restrict__ vc, const uint8_t* __restrict__ vs,
    const __nv_bfloat16* __restrict__ kd, const __nv_bfloat16* __restrict__ vd,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ part, int* __restrict__ tickets, int S, int Hq, int Hkv, int ps,
    int n_pp, int nb, int n_splits, float scale) {
  using Lay = MmaLayout<HD, WK, kPacked>;
  constexpr int CH = HD / 8;    // 16-B chunks of a bf16 row
  constexpr int KF = HD / 16;   // k16 slices of a Q row; pairs of 8-wide d tiles of V
  constexpr int NK = kChunk / WK;  // keys of one warp in a sub-block
  constexpr int NT = NK / 8;       // its 8-key score tiles
  constexpr int NSC = HD / 32;     // scale bytes of one key
  using ScaleWord = typename std::conditional<NSC == 4, uint32_t, uint16_t>::type;
  extern __shared__ __align__(128) uint8_t smem_mma[];
  uint8_t* Qs = smem_mma;
  uint8_t* tiles = Qs + Lay::kQ;                               // packed: K, V tiles
  uint8_t* stages = tiles + (kPacked ? 2 * Lay::kTile : 0);     // two stages
  uint8_t* Sc = stages + 2 * Lay::kStage;                       // packed: scale bytes

  const int chunk = blockIdx.x, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / Hkv, h = bh % Hkv;
  const int group = Hq / Hkv, R = S * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  // pages p with p·ps < length + S - 1 hold every position some row may see
  int n_visit = (length + S - 1 + ps - 1) / ps;
  if (n_visit > n_pp) n_visit = n_pp;
  const int kv_end = n_visit * ps;  // positions on visited pages
  const int chunk_keys = nb * kChunk;
  const int n_cta = max(1, (kv_end + chunk_keys - 1) / chunk_keys);
  if (chunk >= n_cta) return;  // no visible key in this chunk (chunk 0 always runs)
  const int r0 = tile * Lay::RT;
  const int key0 = chunk * chunk_keys;  // first position of the chunk
  // sub-blocks of 64 keys holding a visited position (at least 1)
  const int n_sub = max(1, min(nb, (kv_end - key0 + kChunk - 1) / kChunk));
  const int* trow = tables + static_cast<long long>(b) * n_pp;

  // token row (page·ps + offset)·Hkv + h of position `pos`, or -1 past n_visit
  auto token = [&](int pos) -> long long {
    const int p = pos / ps;
    return p < n_visit ? (static_cast<long long>(trow[p]) * ps + pos % ps) * Hkv + h : -1;
  };
  // cp.async of sub-block j's K and V (codes, or dense rows) into stage j & 1
  auto load_sub = [&](int j) {
    uint8_t* st = stages + Lay::kStage * (j & 1);
    const int pos0 = key0 + j * kChunk;
    if (kPacked) {
      constexpr int CC = HD / 32;  // 16-B chunks of a key's codes
      for (int i = tid; i < kChunk * CC; i += kThreads) {
        const long long tok = token(pos0 + i / CC);
        const int c = i % CC;
        const long long off = tok < 0 ? 0 : tok * (HD / 2) + c * 16;
        cp_async16(st + i * 16, kc + off, tok >= 0);
        cp_async16(st + Lay::kCodes + i * 16, vc + off, tok >= 0);
      }
    } else {
      for (int i = tid; i < kChunk * CH; i += kThreads) {
        const int key = i / CH, ch = i % CH;
        const long long tok = token(pos0 + key);
        const long long off = tok < 0 ? 0 : tok * HD + ch * 8;
        cp_async16(st + swz<HD>(key, ch), kd + off, tok >= 0);
        cp_async16(st + Lay::kTile + swz<HD>(key, ch), vd + off, tok >= 0);
      }
    }
  };
  // packed: one key's scale bytes per thread (K by threads 0-63, V by
  // 64-127), read into a register a sub-block ahead of its use
  auto load_scale = [&](int j) -> ScaleWord {
    if (!kPacked) return 0;
    const long long tok = token(key0 + j * kChunk + tid % kChunk);
    return tok < 0 ? ScaleWord(0)
                   : *reinterpret_cast<const ScaleWord*>((tid < kChunk ? ks : vs) + tok * NSC);
  };

  // ---- prologue: the query tile and sub-block 0 in flight ----
  for (int i = tid; i < Lay::RT * CH; i += kThreads) {
    const int rr = i / CH, ch = i % CH, r = r0 + rr;
    const bool ok = r < R;
    const long long row =
        ok ? (static_cast<long long>(b) * S + r / group) * Hq + h * group + r % group : 0;
    cp_async16(Qs + swz<HD>(rr, ch), q + row * HD + ch * 8, ok);
  }
  load_sub(0);
  cp_async_commit();
  ScaleWord sreg = load_scale(0);

  // warp (wr, wk): query tile wr x keys [wk·NK, (wk+1)·NK) of each sub-block
  const int wr = warp / WK, wk = warp % WK;
  const int row_tile = r0 + wr * 16;
  const bool has_rows = row_tile < R;  // warp-uniform
  const int row_lo = row_tile + (lane >> 2);  // accumulator rows row_lo, row_lo + 8
  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_lo + 8 * i;
    q_pos[i] = r < R ? length - 1 + r / group : -1;  // rows past R see nothing
  }
  const float c = scale * 1.4426950408889634f;  // exp(x·scale) = 2^(x·c)
  // online softmax over the sub-blocks: m = max of the visible (unscaled)
  // scores so far, l = this thread's share of Σp, acc = P·V
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  uint32_t qf[KF][4];

  for (int j = 0; j < n_sub; ++j) {
    if (kPacked) *reinterpret_cast<ScaleWord*>(Sc + tid * NSC) = sreg;  // K keys, then V keys
    if (kPacked && j + 1 < n_sub) sreg = load_scale(j + 1);
    cp_async_wait<0>();
    __syncthreads();  // sub-block j (and at j = 0 the query tile) has landed
    const uint8_t* Ks;
    const uint8_t* Vs;
    if (kPacked) {  // nibbles → bf16, 8 elements (one 16-B chunk) per step
      const uint8_t* st = stages + Lay::kStage * (j & 1);
      for (int i = tid; i < 2 * kChunk * CH; i += kThreads) {
        const bool is_v = i >= kChunk * CH;
        const int u = is_v ? i - kChunk * CH : i;
        const int key = u / CH, ch = u % CH;
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(st + (is_v ? Lay::kCodes : 0) + key * (HD / 2) + ch * 4);
        const int sc = Sc[(is_v ? kChunk : 0) * NSC + key * NSC + ch / 4];
        *reinterpret_cast<uint4*>(tiles + (is_v ? Lay::kTile : 0) + swz<HD>(key, ch)) =
            dequant8(w, sc);
      }
      __syncthreads();  // the tiles are ready; the stage and the scales are free
      Ks = tiles;
      Vs = tiles + Lay::kTile;
    } else {
      Ks = stages + Lay::kStage * (j & 1);
      Vs = Ks + Lay::kTile;
    }
    // the next sub-block loads while this one is multiplied (its stage was
    // last read before this sub-block's first barrier)
    if (j + 1 < n_sub) load_sub(j + 1);
    cp_async_commit();
    if (!has_rows) continue;
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KF; ++kk)
        ldmatrix_x4(qf[kk], Qs + swz<HD>(wr * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }

    // S = Q·Kᵀ on this warp's keys, unscaled
    float sc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KF; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t t[4];
        ldmatrix_x4(t, Ks + swz<HD>(wk * NK + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], qf[kk], t[0], t[1], sc[2 * np]);
        mma_bf16(sc[2 * np + 1], qf[kk], t[2], t[3], sc[2 * np + 1]);
      }

    // masks: position past the row's causal bound or on a page past n_visit
    const int k0 = key0 + j * kChunk + wk * NK;
    bool vis[NT][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        vis[nt][e] = k_pos <= q_pos[e >> 1] && k_pos < kv_end;
        if (vis[nt][e]) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float mc[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      corr[i] = ex2((m_r[i] - m_new) * c);  // 0 after only masked keys; 1 while both are -1e30
      m_r[i] = m_new;
      mc[i] = m_new * c;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = vis[nt][e] ? ex2(fmaf(sc[nt][e], c, -mc[e >> 1])) : 0.f;
        sc[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + sum[i];
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[t][e] *= corr[e >> 1];

    // P·V: the score tiles 2kc, 2kc + 1 are the A fragment of key slice kc
#pragma unroll
    for (int kc2 = 0; kc2 < NK / 16; ++kc2) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kc2][0], sc[2 * kc2][1], ph[0], pl[0]);
      split_bf16(sc[2 * kc2][2], sc[2 * kc2][3], ph[1], pl[1]);
      split_bf16(sc[2 * kc2 + 1][0], sc[2 * kc2 + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kc2 + 1][2], sc[2 * kc2 + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KF; ++dp) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, Vs + swz<HD>(wk * NK + kc2 * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                          2 * dp + (lane >> 4)));
        mma_bf16(oacc[2 * dp], ph, t[0], t[1], oacc[2 * dp]);
        mma_bf16(oacc[2 * dp], pl, t[0], t[1], oacc[2 * dp]);
        mma_bf16(oacc[2 * dp + 1], ph, t[2], t[3], oacc[2 * dp + 1]);
        mma_bf16(oacc[2 * dp + 1], pl, t[2], t[3], oacc[2 * dp + 1]);
      }
    }
  }

  // ---- partial of split chunk·WK + wk for each of this thread's rows ----
  const int split = chunk * WK + wk;
  const long long n_rows = static_cast<long long>(bh) * R;  // this (slot, head)'s first row
  float* part_acc = part;
  float* part_ml = part + static_cast<long long>(gridDim.z) * R * n_splits * HD;
  if (has_rows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_lo + 8 * i;
      const float l = quad_sum(l_r[i]);
      if (r >= R) continue;
      const long long slot = (n_rows + r) * n_splits + split;
      float* acc = part_acc + slot * HD + 2 * (lane & 3);
#pragma unroll
      for (int t = 0; t < HD / 8; ++t)
        *reinterpret_cast<float2*>(acc + t * 8) = make_float2(oacc[t][2 * i], oacc[t][2 * i + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(part_ml + slot * 2) =
            make_float2(l > 0.f ? m_r[i] * c : kNegInf, l);
    }
  }

  // ---- combine: the last CTA of this (slot, head, tile) merges the splits ----
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* ticket = tickets + static_cast<long long>(bh) * gridDim.y + tile;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_cta - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;  // ready for the next launch, no memset needed

  const int n_used = n_cta * WK;
  float2* sML = reinterpret_cast<float2*>(smem_mma);  // [RT][n_used]; the tiles are free
  float* sL = reinterpret_cast<float*>(sML + Lay::RT * n_used);
  for (int i = tid; i < Lay::RT * n_used; i += kThreads) {
    const int rr = i / n_used, s = i % n_used, r = r0 + rr;
    sML[i] = r < R ? __ldcg(reinterpret_cast<const float2*>(part_ml) + (n_rows + r) * n_splits + s)
                   : make_float2(kNegInf, 0.f);
  }
  __syncthreads();
  for (int rr = tid; rr < Lay::RT; rr += kThreads) {
    float2* ml = sML + rr * n_used;
    float M = kNegInf;
    for (int s = 0; s < n_used; ++s)
      if (ml[s].y > 0.f) M = fmaxf(M, ml[s].x);
    float L = 0.f;
    for (int s = 0; s < n_used; ++s) {  // in chunk order; weight in place of m
      const float w = ml[s].y > 0.f ? ex2(ml[s].x - M) : 0.f;
      ml[s].x = w;
      L = __fadd_rn(L, __fmul_rn(ml[s].y, w));
    }
    sL[rr] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  constexpr int D4 = HD / 4;
  for (int i = tid; i < Lay::RT * D4; i += kThreads) {
    const int rr = i / D4, d4 = i % D4, r = r0 + rr;
    if (r >= R) continue;
    const float2* ml = sML + rr * n_used;
    const float4* acc = reinterpret_cast<const float4*>(part_acc) + (n_rows + r) * n_splits * D4 + d4;
    // every split below n_used wrote acc (0 where l = 0), so the loads are
    // unconditional: 8 in flight at a time, then added in chunk order
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_used; s0 += 8) {
      float4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = s0 + u < n_used ? __ldcg(acc + (s0 + u) * D4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float w = s0 + u < n_used ? ml[s0 + u].x : 0.f;
        o.x = __fadd_rn(o.x, __fmul_rn(w, a[u].x));
        o.y = __fadd_rn(o.y, __fmul_rn(w, a[u].y));
        o.z = __fadd_rn(o.z, __fmul_rn(w, a[u].z));
        o.w = __fadd_rn(o.w, __fmul_rn(w, a[u].w));
      }
    }
    const float den = sL[rr];
    const long long row = (static_cast<long long>(b) * S + r / group) * Hq + h * group + r % group;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + row * HD + d4 * 4);
    dst[0] = __floats2bfloat162_rn(o.x / den, o.y / den);
    dst[1] = __floats2bfloat162_rn(o.z / den, o.w / den);
  }
}

template <int HD, int WK, bool kPacked>
int launch_mma_t(const void* q, void* out, const void* kc, const void* ks, const void* vc,
                 const void* vs, const void* kd, const void* vd, const void* tables,
                 const void* lengths, void* part, void* tickets, int B, int S, int Hq, int Hkv,
                 int ps, int n_pp, int nb, float scale, cudaStream_t stream) {
  using Lay = MmaLayout<HD, WK, kPacked>;
  auto kernel = paged_mma_kernel<HD, WK, kPacked>;
  // the combine reuses the tiles for its (m, l) table: [RT][n_splits] float2 + RT floats
  static_assert(Lay::RT * (kMaxChunks * WK * 8 + 4) <= Lay::bytes(),
                "the combine's table outgrows the body's shared memory");
  const int R = S * (Hq / Hkv);
  const int n_chunks = (n_pp * ps + nb * kChunk - 1) / (nb * kChunk);
  if (n_chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = n_chunks * WK;
  constexpr int smem = Lay::bytes();
  static bool ready[64] = {};  // the dynamic shared-memory limit set, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {  // also below 48 KB: the static bytes count too
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const dim3 grid(n_chunks, (R + Lay::RT - 1) / Lay::RT, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      static_cast<const uint8_t*>(kc), static_cast<const uint8_t*>(ks),
      static_cast<const uint8_t*>(vc), static_cast<const uint8_t*>(vs),
      static_cast<const __nv_bfloat16*>(kd), static_cast<const __nv_bfloat16*>(vd),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(part), static_cast<int*>(tickets), S, Hq, Hkv, ps, n_pp, nb, n_splits,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kPacked>
int launch_mma_wk(int wk, int nb, const void* q, void* out, const void* kc, const void* ks,
                  const void* vc, const void* vs, const void* kd, const void* vd,
                  const void* tables, const void* lengths, void* part, void* tickets, int B,
                  int S, int Hq, int Hkv, int ps, int n_pp, float scale, cudaStream_t stream) {
  switch (wk) {
    case 1:
      return launch_mma_t<HD, 1, kPacked>(q, out, kc, ks, vc, vs, kd, vd, tables, lengths, part,
                                          tickets, B, S, Hq, Hkv, ps, n_pp, nb, scale, stream);
    case 4:
      return launch_mma_t<HD, 4, kPacked>(q, out, kc, ks, vc, vs, kd, vd, tables, lengths, part,
                                          tickets, B, S, Hq, Hkv, ps, n_pp, nb, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

}  // namespace

// q/out [B, S, Hq, hd] contiguous (f32 or bf16); packed pool leaves
// [n_pages, ps, Hkv, hd/2] and [n_pages, ps, Hkv, hd/32] u8, or dense leaves
// [n_pages, ps, Hkv, hd] in q's dtype; tables [B, n_pp] and lengths [B] int32.
// Requires hd % 32 == 0, hd <= 128, ps <= 32.
//
// part == NULL: the FMA body.  Otherwise the tensor-core body, which needs
// bf16, hd in {64, 128}, 64 % ps == 0, 16-byte aligned q, out and pool
// leaves (scale leaves: hd/32-byte aligned), wk in {1, 4} (4 / wk query
// tiles of 16 rows per CTA), nb sub-blocks of 64 keys per CTA with
// n_chunks = ceil(n_pp·ps / (64·nb)) <= 32, `part` f32 scratch of
// B·Hkv·R·n_splits·(hd + 2) floats with R = S·Hq/Hkv, n_splits =
// n_chunks·wk, and `tickets` int32 [B·Hkv·ceil(R / (64 / wk))], zero before
// the first launch (each launch leaves it zero).
extern "C" int paged_attention(const void* q, void* out, int is_bf16, int packed,
                               const void* kc, const void* ks, const void* vc, const void* vs,
                               const void* kd, const void* vd, const void* tables,
                               const void* lengths, int B, int S, int Hq, int Hkv, int hd,
                               int ps, int n_pp, float scale, void* part, void* tickets, int wk,
                               int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part != nullptr) {
    const bool ok = is_bf16 && (hd == 64 || hd == 128) && ps > 0 && 64 % ps == 0 && nb >= 1 &&
                    aligned(q, 16) && aligned(out, 16) && aligned(part, 16) &&
                    (packed ? aligned(kc, 16) && aligned(vc, 16) && aligned(ks, hd / 32) &&
                                  aligned(vs, hd / 32)
                            : aligned(kd, 16) && aligned(vd, 16));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 128)
      return packed ? launch_mma_wk<128, true>(wk, nb, q, out, kc, ks, vc, vs, kd, vd, tables,
                                               lengths, part, tickets, B, S, Hq, Hkv, ps, n_pp,
                                               scale, s)
                    : launch_mma_wk<128, false>(wk, nb, q, out, kc, ks, vc, vs, kd, vd, tables,
                                                lengths, part, tickets, B, S, Hq, Hkv, ps, n_pp,
                                                scale, s);
    return packed ? launch_mma_wk<64, true>(wk, nb, q, out, kc, ks, vc, vs, kd, vd, tables, lengths,
                                            part, tickets, B, S, Hq, Hkv, ps, n_pp, scale, s)
                  : launch_mma_wk<64, false>(wk, nb, q, out, kc, ks, vc, vs, kd, vd, tables, lengths,
                                             part, tickets, B, S, Hq, Hkv, ps, n_pp, scale, s);
  }
  if (is_bf16)
    return launch<__nv_bfloat16>(q, out, packed, kc, ks, vc, vs, kd, vd, tables, lengths, B, S,
                                 Hq, Hkv, hd, ps, n_pp, scale, s);
  return launch<float>(q, out, packed, kc, ks, vc, vs, kd, vd, tables, lengths, B, S, Hq, Hkv,
                       hd, ps, n_pp, scale, s);
}
