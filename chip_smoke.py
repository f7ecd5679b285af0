"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds every kernel of the
   serving, training and evaluation paths from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together: 6 libraries, 7 kernels), and
   prints each entry's registers, shared memory and spills (-Xptxas -v);
   B4b's body must use no stack and spill nothing.
2. Checks each kernel against its plain PyTorch version on the card at the
   full-width qwen3-1.7b shapes of the serving path and the full-width
   llama-paper-200m shapes of a training step (16 x 512 tokens): B1 (QuEST
   quantize) bit for bit, with an E8M0 edge sweep; B5 (paged attention) on
   both pools at decode and prefill shapes and at the edges of its split
   over CTAs (lengths 1, 16, 32, a full table, a page of E8M0 scale codes
   1 and 2); B4a
   (KV quantize-pack and its pool scatter, K and V in one launch, strided
   inputs) bit for bit, with an E8M0 edge sweep; B4b (unpack-dequantize
   and its page gather, K and V in one launch) bit for bit over every
   (byte, scale code) pair and over ragged page tables; B2 (SR-Hadamard
   quantize) bit for bit at the four backward operands of the up and down
   projections as the training path lays them out; B3 (MXFP4 GEMM) bit for
   bit at ragged M and N and at E8M0-edge scales; B6 (flash
   attention) at the evaluation shape, qwen3-1.7b's GQA at 4096, a ragged
   f32 case and a ragged hd-64 bf16 case, with SDPA as a second reading;
   and one full-width ``quartet_linear`` backward on the kernels against
   the same backward on the plain versions (a mismatch raises).
3. Serves 8 requests with the port's ``Engine`` on full-width, full-depth
   qwen3-1.7b (random weights from a seed, MXFP4 KV pool, paged attention,
   greedy decoding, Quartet linears through the kernels), with every launch
   counter set to 0 just before and read just after, against the predicted
   counts (B4a one launch per layer write, and every B1 launch on its
   vector body, on every path); then
   the first 4 requests on the gather backend (per-slot
   prefill, gather-dequantize, dense attention, scatter back), its launches
   against the per-slot schedule and its first-token log-probs against the
   paged run's; then holds a reduced model's engine tokens against its own
   teacher-forced forward and the gather tokens against the paged ones.
4. Trains: a reduced Llama 3 steps on the card (kernels) and on the CPU
   (plain versions), losses and grad-norms compared; then full-width,
   full-depth llama-paper-200m 5 steps through ``train.loop.train`` (batch
   32 x 512, 2 microbatches, Quartet on every transformer linear), with every
   launch counter set to 0 just before and read just after, beside the
   predicted counts (every B2 launch on its vector body); prints tokens/s,
   the median step time and peak memory;
   then evaluates the trained state on 4 held-out batches of 16 x 512 with
   the training model (blocked attention) and a flash-built one (B6, 40
   launches), the two nll values held to a stated tolerance.
5. Times each kernel (CUDA events, median, L2 flushed before each launch)
   beside its plain version and, where one PyTorch call computes the same
   function, that call, at serving, training and evaluation shapes; B1, B2,
   B3, B4a, B4b and B5 also as a CUDA-graph replay (device time without the
   host gaps), B1's serving layer also as its 7 weight and its 7 activation
   calls apart; B4a as the layer's KV write through ``scatter_token``.
6. Prints one JSON line of kernel records, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
when run outside a checkout of the repository.  ``--phases`` runs a subset
(for iterating); the default runs them all.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_OPS = 989e12  # dense tensor-core peak
H100_INT8_OPS = 1979e12
# one instruction a lane outside the tensor cores: f32 at 128 a clock a SM
# (the data sheet's 67 TFLOP/s of f32 counts an FMA as two flops), int32 at
# 64 a clock a SM, half that (CUDA C++ Programming Guide, throughput of the
# arithmetic instructions, compute capability 9.0); a SM issues at most 128
# instructions a clock in all (one warp instruction a scheduler)
H100_F32_OPS = 67e12 / 2
H100_INT32_OPS = H100_F32_OPS / 2

# B2's operations per element, the fewest its exact form needs (the vector
# body's arithmetic in csrc/sr_hadamard_quant.cu), by the unit that runs
# them.  f32 (add, multiply, compare, min/max, select, conversion): the sign
# (1), the butterfly (5), the two prescalings (2), the absmax (1), v·2^-e
# (1); the uniform's int -> float and ·2^-24 (2); the SR's max(|v|, 1),
# |v|·2^(1-E), floor, x - floor, the compare with u, + 1, the select, ·2^E
# and the min with 12 (9); the code byte's + 1.5·2^23 (1).  int32: the
# index (1), two murmur3 fmix rounds (2 x (3 shifts, 3 xors, 2
# multiplies)), the hash's constant add and its shift by 8 (2); the SR's
# exponent mask, 2^(1-E) from it and the sign copy (3); 3 byte permutes
# for a word of 4 codes (0.75).  The per-group division and E8M0 rounding
# are 1/32 of that and left out.  The bound is the larger of the int32
# work at its rate and all of it at the issue rate.
B2_F32_OPS = 1 + 5 + 2 + 1 + 1 + 2 + 9 + 1
B2_INT32_OPS = 1 + 16 + 2 + 3 + 0.75

# serving traffic of the engine phase
N_SLOTS, PAGE_SIZE, MAX_LEN, PREFILL_CHUNK = 8, 16, 640, 64
LONG_CONTEXT = 32768  # qwen3-1.7b's published context: B5's widest table checked
N_REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 8, 128, 512, 32
SEED = 0

# the gather-backend run of the engine phase: the first GATHER_REQUESTS of
# the phase's requests, GATHER_NEW new tokens each
GATHER_REQUESTS, GATHER_NEW = 4, 16

# evaluation of the train phase: held-out batches of EVAL_BATCH x TRAIN_SEQ
EVAL_BATCHES, EVAL_BATCH = 4, 16

# training traffic of the train phase (the paper's sequence length; its batch
# of 512 sequences would be --microbatch 32 at the same per-microbatch size)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = "llama-paper-200m", 5, 32, 512, 2
TRAIN_TOKENS_MB = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ  # 8192 tokens per microbatch


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(path: str, key: str) -> dict[str, int]:
    """Static SASS instruction count of each entry of the built library at
    ``path`` whose (mangled) name contains ``key`` (``cuobjdump -sass``);
    empty where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def entry_resources(report: str, key: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of each entry whose (mangled)
    name contains ``key``, from an ``-Xptxas -v`` report."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            if name:
                out[name] = {}
        elif name and "stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
            out[name].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of a callable, with the 50 MB L2 flushed before
    every timed call (the serving path streams 3.4 GB of weights per step,
    so it never finds its operands in L2)."""

    def __init__(self, torch, reps: int = 15):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def device(self, fn) -> float:
        """Device time of ``fn``'s launches without the host between them:
        ``fn`` captured once in a CUDA graph (after a warm-up call, so that
        one-time set-up stays outside), the graph's replay timed as above."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self(graph.replay)


# ---------------------------------------------------------------------------
# shapes of the serving path
# ---------------------------------------------------------------------------


def linear_shapes(cfg):
    """(name, K, N) of the 7 Quartet linears of one layer."""
    d, hd = cfg.d_model, cfg.head_dim_
    return [("q", d, cfg.num_heads * hd), ("k", d, cfg.num_kv_heads * hd),
            ("v", d, cfg.num_kv_heads * hd), ("o", cfg.num_heads * hd, d),
            ("gate", d, cfg.d_ff), ("up", d, cfg.d_ff), ("down", cfg.d_ff, d)]


def make_pool(torch, cfg, lengths, packed: bool, dtype, gen, device, n_pp: int):
    """One layer's pool with every slot's first ``lengths[b]`` positions
    written through the port's quantize-on-write, plus its page tables."""
    from repro_torch.kernels.paged_attention import quant_block, scatter_token

    B, Hkv, hd = len(lengths), cfg.num_kv_heads, cfg.head_dim_
    n_pages = 1 + B * n_pp
    if packed:
        nb = hd // quant_block(hd)
        pool = {n: torch.zeros(s, dtype=torch.uint8, device=device) for n, s in (
            ("k_codes", (n_pages, PAGE_SIZE, Hkv, hd // 2)),
            ("k_scales", (n_pages, PAGE_SIZE, Hkv, nb)),
            ("v_codes", (n_pages, PAGE_SIZE, Hkv, hd // 2)),
            ("v_scales", (n_pages, PAGE_SIZE, Hkv, nb)))}
    else:
        pool = {n: torch.zeros((n_pages, PAGE_SIZE, Hkv, hd), dtype=dtype, device=device)
                for n in ("k", "v")}
    tables = torch.zeros((B, n_pp), dtype=torch.int32, device=device)
    nxt = 1
    for b, n in enumerate(lengths):
        for p in range(-(-n // PAGE_SIZE)):
            tables[b, p] = nxt
            nxt += 1
    for b, n in enumerate(lengths):
        t = torch.arange(n, device=device)
        k = torch.randn((n, Hkv, hd), generator=gen, device=device) * 1.5
        v = torch.randn((n, Hkv, hd), generator=gen, device=device) * 1.5
        scatter_token(pool, tables[b, t // PAGE_SIZE], t % PAGE_SIZE, k.to(dtype), v.to(dtype))
    return pool, tables


def attention_bytes_ops(cfg, lengths, S: int, packed: bool, q_bytes: int):
    """Least bytes and operations of paged attention for this run's data:
    q read and out written once, each slot's visible KV read once."""
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    kv_tok = Hkv * (hd // 2 + hd // 32) if packed else Hkv * hd * q_bytes
    nbytes = 2 * len(lengths) * S * Hq * hd * q_bytes
    ops = 0
    for n in lengths:
        nbytes += 2 * kv_tok * (n + S - 1) + 4 * (-(-(n + S - 1) // PAGE_SIZE))
        ops += sum(4 * Hq * hd * (n + s) for s in range(S))
    return nbytes, ops


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------


def e8m0_edge_rows(torch, gen, device):
    """Rows whose first group is one nonzero v: after the Hadamard every
    element is ±fl(v/√32), so c*·rms/6 lands within a few ulps of √2·2^k —
    the rounding edge of the E8M0-nearest scale — for k in [-30, 30]."""
    import numpy as np

    from repro_torch.kernels.hadamard_quant import _H_SCALE, _clip_c

    vs = []
    for k in range(-30, 31):
        v0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0 / _clip_c() / _H_SCALE)
        bits = v0.view(np.int32)
        vs.extend((bits + np.arange(-6, 7, dtype=np.int32)).view(np.float32).tolist())
    x = torch.zeros((len(vs), 64), dtype=torch.float32, device=device)
    x[:, 0] = torch.tensor(vs, dtype=torch.float32, device=device)
    x[:, 32:] = torch.randn((len(vs), 32), generator=gen, device=device)
    return x


def check_kernels(torch, cfg, device="cuda"):
    """Every kernel against its plain version at the serving path's shapes;
    raises on a mismatch.  Returns {kernel: max abs error}."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {}

    # hadamard_quest_quantize: bit-exact (codes, scales, mask) on activations
    # at decode and prefill-chunk rows, on every weight's Wᵀ view, and on the
    # E8M0 edge sweep
    cases = [("edge", e8m0_edge_rows(torch, gen, device))]
    for m in (N_SLOTS, N_SLOTS * PREFILL_CHUNK):
        for K in (cfg.d_model, cfg.d_ff):
            cases.append((f"x[{m},{K}]", torch.randn((m, K), generator=gen, device=device)
                          .mul_(1.9).to(torch.bfloat16)))
    for name, K, N in linear_shapes(cfg):
        w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
        cases.append((f"W_{name}ᵀ", w.t()))
    for name, x in cases:
        got = HQ.hadamard_quest_quantize(x)
        want = HQ.hadamard_quest_quantize_plain(x)
        for g, w_, what in zip(got, want, ("codes", "scales", "mask")):
            if not torch.equal(g, w_):
                n = int((g != w_).sum())
                raise AssertionError(f"hadamard_quest_quantize {name}: {what} differ at {n} places")
    err["hadamard_quest_quantize"] = 0.0

    # mxfp4_matmul: A codes from activations, B = the transposed view of Wᵀ
    # codes, exactly as quartet_linear passes them
    worst = 0.0
    for m in (N_SLOTS, N_SLOTS * PREFILL_CHUNK):
        for name, K, N in linear_shapes(cfg):
            x = torch.randn((m, K), generator=gen, device=device).to(torch.bfloat16)
            w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
            ac, as_, _ = HQ.hadamard_quest_quantize(x)
            wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
            got = MM.mxfp4_matmul(ac, as_, wc.t(), ws.t())
            want = MM.mxfp4_matmul_plain(ac, as_, wc.t(), ws.t())
            # the kernel adds the exact per-group integer products in group
            # order, as the plain version does: equal up to rtol 1e-6 / atol
            # 1e-5, the reference's own tolerance, for K up to 6144
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-5):
                raise AssertionError(f"mxfp4_matmul M={m} {name}: max |Δ| "
                                     f"{float((got - want).abs().max())}")
            worst = max(worst, float((got - want).abs().max()))
    err["mxfp4_matmul"] = worst

    # mxfp4_matmul bit for bit at ragged M and N (every tile configuration:
    # decode M <= 16, prefill, training) and at the E8M0 edges
    for m in (8, 100, 1100):
        x = torch.randn((m, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cfg.d_model, 1000), generator=gen, device=device)
             / cfg.d_model**0.5).to(torch.bfloat16)
        ac, as_, _ = HQ.hadamard_quest_quantize(x)
        wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
        cases = [(f"ragged M={m} N=1000", (ac, as_, wc.t(), ws.t()))]
        cases += [(f"E8M0 {name} M={m}", args)
                  for name, args in mxfp4_edge_operands(torch, gen, device, m)]
        for name, args in cases:
            got, want = MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args)
            if not torch.equal(got, want):
                bad = got != want
                raise AssertionError(f"mxfp4_matmul {name}: differs at {int(bad.sum())} places, "
                                     f"e.g. {got[bad][:4].tolist()} vs {want[bad][:4].tolist()}")

    # paged_attention: both pool kinds, S = 1 (decode) and S = C (prefill
    # chunk), f32 queries (tolerance 2e-5: online vs full softmax, another
    # summation order) and bf16 queries (the engine's type: one bf16
    # rounding step, rtol 2^-7)
    lengths = [640 - 16 * i * 7 for i in range(N_SLOTS)]  # 640 .. 24, ragged
    n_pp = MAX_LEN // PAGE_SIZE + 1
    worst = 0.0
    for packed in (True, False):
        for dtype, rtol, atol in ((torch.float32, 0.0, 2e-5), (torch.bfloat16, 2**-7, 1e-5)):
            for S in (1, PREFILL_CHUNK):
                lens = [max(n - S + 1, 1) for n in lengths]
                pool, tables = make_pool(torch, cfg, [n + S - 1 for n in lens], packed,
                                         dtype, gen, device, n_pp)
                q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                                device=device).to(dtype)
                q = q[:, 0] if S == 1 else q
                ln = torch.tensor(lens, dtype=torch.int32, device=device)
                got = PA.paged_attention(q, pool, tables, ln).float()
                want = PA.paged_attention_plain(q, pool, tables, ln).float()
                bad = (got - want).abs() > atol + rtol * want.abs()
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(
                        f"paged_attention packed={packed} {dtype} S={S}: {int(bad.sum())} "
                        f"elements off, max |Δ| {float((got - want).abs().max())}")
                if dtype == torch.float32:
                    worst = max(worst, float((got - want).abs().max()))
    worst = max(worst, check_paged_edges(torch, cfg, gen, device))
    err["paged_attention"] = worst
    torch.cuda.synchronize()
    return err


def check_paged_edges(torch, cfg, gen, device):
    """B5 at the edges of the split over CTAs, both pool kinds, f32 and bf16,
    S = 1 and S = 64: slots of length 1 (one visible key), 16 and 32 (page
    multiples: the last chunk's tail empty), one whose rows pass the end of a
    full table (clamped at n_pp) and long ones; on the packed pool slot 0's
    first page and slot 5's second carry E8M0 scale codes 1 and 2 (2^-126,
    2^-125: subnormal bf16 operands, which the tensor core may flush, far
    below the atol).  Then the same over a table of 32768 positions
    (qwen3-1.7b's published context), where the split's chunk cap gives
    each CTA several sub-blocks.  Raises on a mismatch; returns the f32 max
    |Δ|."""
    from repro_torch.kernels import paged_attention as PA

    worst = 0.0
    tables = ((MAX_LEN // PAGE_SIZE + 1,
               lambda full, S: [1, 16, 32, full - S // 2, 1, 300, full - 16 * 7 - S + 1, 17]),
              (LONG_CONTEXT // PAGE_SIZE,
               lambda full, S: [1, 700, full - S // 2, 9000, 16, 20000, 4096, 33]))
    for n_pp, lengths in tables:
        worst = max(worst, _check_paged_edges_at(torch, PA, cfg, gen, device, n_pp, lengths))
    return worst


def _check_paged_edges_at(torch, PA, cfg, gen, device, n_pp, lengths):
    full = n_pp * PAGE_SIZE
    worst = 0.0
    for packed in (True, False):
        for dtype, rtol, atol in ((torch.float32, 0.0, 2e-5), (torch.bfloat16, 2**-7, 1e-5)):
            for S in (1, PREFILL_CHUNK):
                lens = lengths(full, S)
                pool, tables = make_pool(torch, cfg, [min(n + S - 1, full) for n in lens],
                                         packed, dtype, gen, device, n_pp)
                if packed:
                    for b, p in ((0, 0), (5, 1)):
                        page = int(tables[b, p])
                        for name in ("k_scales", "v_scales"):
                            pick = torch.randint(1, 3, pool[name][page].shape, generator=gen,
                                                 device=device, dtype=torch.int32)
                            pool[name][page] = pick.to(torch.uint8)
                q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                                device=device).to(dtype)
                q = q[:, 0] if S == 1 else q
                ln = torch.tensor(lens, dtype=torch.int32, device=device)
                got = PA.paged_attention(q, pool, tables, ln).float()
                want = PA.paged_attention_plain(q, pool, tables, ln).float()
                bad = (got - want).abs() > atol + rtol * want.abs()
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(
                        f"paged_attention edges n_pp={n_pp} packed={packed} {dtype} S={S}: "
                        f"{int(bad.sum())} elements off, max |Δ| "
                        f"{float((got - want).abs().max())}")
                if dtype == torch.float32:
                    worst = max(worst, float((got - want).abs().max()))
    return worst


def mxfp4_edge_operands(torch, gen, device, m: int, k: int = 256, n: int = 200):
    """B3 operands [m, k] x [k, n] (B K-major, as the call sites pass it) at
    the E8M0 edges, half-codes from the E2M1 grid.  "low": signed codes and
    scale codes 1, 2 (2^-126, 2^-125) beside 100 and 127, so terms underflow
    to zero or round in f32's subnormal range; "high": codes >= 0 and scale
    codes 253, 254 (2^126, 2^127) beside 1, 2, 120, 127 and 134, so terms
    overflow to +inf (never inf - inf, so no NaN); "fold limits": scale codes
    67 and 177 (2^-60, 2^50), the bounds of the kernel's folded-scale path."""
    grid = torch.tensor([0, 1, 2, 3, 4, 6, 8, 12], dtype=torch.int8, device=device)

    def codes(shape, signed):
        c = grid[torch.randint(0, 8, shape, generator=gen, device=device)]
        if signed:
            c = c * (torch.randint(0, 2, shape, generator=gen, device=device) * 2 - 1).to(torch.int8)
        return c

    def scales(shape, e8m0):
        e = torch.tensor(e8m0, dtype=torch.int32, device=device)
        pick = e[torch.randint(0, len(e8m0), shape, generator=gen, device=device)]
        return (pick << 23).view(torch.float32)  # 2^(code - 127), built from the bits

    out = []
    for name, kk, signed, ea, eb in (
            ("low", k, True, (1, 2, 100, 127), (1, 2, 100, 127)),
            # two groups, so that most outputs stay finite beside the +inf ones
            ("high", 64, False, (253, 254, 127, 127, 120, 1), (1, 2, 127, 127, 134, 254)),
            ("fold limits", k, True, (67, 177, 127), (67, 177, 127))):
        out.append((name, (codes((m, kk), signed), scales((m, kk // 32), ea),
                           codes((n, kk), signed).t(), scales((n, kk // 32), eb).t())))
    return out


def kv_edge_rows(np):
    """Rows of two 32-groups whose first group's absmax/6 lies within ±8 ulps
    of √2·2^k (the E8M0-nearest rounding edge) or exactly at 2^k, for k in
    [-100, 100], plus all-zero rows (f32)."""
    rng = np.random.default_rng(SEED)
    amax = []
    for k in range(-100, 101):
        a0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0)
        amax.extend((a0.view(np.int32) + np.arange(-8, 9, dtype=np.int32)).view(np.float32))
        amax.append(np.float32(6.0 * 2.0**k))
    amax = np.asarray(amax, np.float32)
    x = np.zeros((amax.size + 8, 64), np.float32)
    x[:amax.size, 1:32] = rng.uniform(-0.9, 0.9, (amax.size, 31)) * amax[:, None]
    x[:amax.size, 0] = amax * np.where(rng.random(amax.size) < 0.5, -1, 1)
    x[:amax.size, 32:] = rng.standard_normal((amax.size, 32))
    return x


def every_pair(torch, shape_codes, shape_scales, shift, device):
    """B4b operands holding every (byte, scale code) pair once in every 4096
    consecutive groups of 16 code bytes: byte f of the flat codes is (f +
    16·shift) mod 256, group g's scale code (g // 16 + shift) mod 256 (0 and
    255, the zero and infinite scales, included)."""
    nc, ns = math.prod(shape_codes), math.prod(shape_scales)
    codes = ((torch.arange(nc, device=device) + 16 * shift) % 256).to(torch.uint8)
    scales = ((torch.arange(ns, device=device) // 16 + shift) % 256).to(torch.uint8)
    return codes.reshape(shape_codes), scales.reshape(shape_scales)


def bit_pattern(torch, x):
    """x's bits as integers of its width (``torch.equal`` is false on NaN)."""
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def plain_quant_scatter(torch, codes, scales, page_ids, offsets, x):
    """B4a's scatter form from its plain version: quantize the rows, then
    write them with PyTorch indexing (leaves with a leading [L] axis)."""
    from repro_torch.kernels import kv_pack as KV

    L, n, H, K = x.shape
    c, s = KV.kv_quant_pack_plain(x.reshape(-1, K))
    pid, off = page_ids.long(), offsets.long()
    codes[:, pid, off] = c.reshape(L, n, H, -1)
    scales[:, pid, off] = s.reshape(L, n, H, -1)


def flash_plain(FA, q, k, v, causal):
    """B6's plain version over [B, S, Hq, hd] x [B, T, Hkv, hd], in the
    kernel's 64-blocks."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = FA.flash_attention_plain(q.transpose(1, 2).reshape(B * Hq, S, hd),
                                 k.transpose(1, 2).reshape(B * Hkv, T, hd),
                                 v.transpose(1, 2).reshape(B * Hkv, T, hd), causal,
                                 q_heads=Hq, kv_heads=Hkv)
    return o.reshape(B, Hq, S, hd).transpose(1, 2)


def sdpa(torch, q, k, v, causal):
    """One PyTorch call computing B6's function (a yardstick, never on the
    port's path): [B, H, S, hd] operands, GQA by ``enable_gqa``."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                            enable_gqa=True)


def flash_shapes(cfg, tcfg):
    """(name, B, S, T, Hq, Hkv, hd, causal, dtype name) of B6's checks: the
    evaluation shape, qwen3-1.7b's GQA at 4096, a ragged f32 case and a
    ragged bf16 case at hd 64 with S != T (the tensor-core body's other
    head size)."""
    return [("eval", EVAL_BATCH, TRAIN_SEQ, TRAIN_SEQ, tcfg.num_heads, tcfg.num_kv_heads,
             tcfg.head_dim_, True, "bfloat16"),
            ("gqa4096", 1, 4096, 4096, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, True,
             "bfloat16"),
            ("f32_1000", 2, 1000, 1000, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, False,
             "float32"),
            ("hd64_700x1000", 2, 700, 1000, 4, 2, 64, False, "bfloat16")]


def check_gather_dequant(torch, cfg, gen, device="cuda"):
    """B4b against its plain version, bit-exact in f32 and bf16 (compared
    by bit pattern: NaN included); raises on a mismatch.  The gather of a
    full-width decode tick (28 layers, 8 slots x 40 pages of 16), K's leaves
    holding every (byte, scale code) pair, V's random bytes at the scale
    codes of real data; the one-launch K+V form against the one-leaf form and
    the plain version, also over ragged tables (the scratch page 0, a page
    read twice, P = 1); the 2-d form over every pair, with a short last
    chunk, with rows longer than a tile, and over a whole pool's rows."""
    from repro_torch.kernels import kv_pack as KV

    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    leaves = list(every_pair(torch, (L, n_pages, PAGE_SIZE, Hkv, hd // 2),
                             (L, n_pages, PAGE_SIZE, Hkv, hd // 32), 0, device))
    leaves.append(torch.randint(0, 256, (L, n_pages, PAGE_SIZE, Hkv, hd // 2), generator=gen,
                                device=device, dtype=torch.uint8))
    leaves.append(torch.randint(100, 155, (L, n_pages, PAGE_SIZE, Hkv, hd // 32), generator=gen,
                                device=device, dtype=torch.uint8))
    tick = (1 + torch.randperm(n_pages - 1, generator=gen, device=device)
            ).to(torch.int32).reshape(N_SLOTS, -1)
    ragged = torch.tensor([[7, 1, 0, 0, 0], [n_pages - 1, 3, 3, 9, 0], [2, 0, 0, 0, 0]],
                          dtype=torch.int32, device=device)
    for tables in (tick, ragged, ragged[:, :1].contiguous()):
        idx = tables.long()
        for dt in (torch.float32, torch.bfloat16):
            before = KV.kv_dequant_unpack.launches
            got = KV.kv_gather_dequant_kv(*leaves, tables, dt)
            if KV.kv_dequant_unpack.launches - before != 1:
                raise AssertionError("kv_gather_dequant_kv: not one launch for K and V")
            for name, g, (c, sc) in (("K", got[0], leaves[:2]), ("V", got[1], leaves[2:])):
                want = KV.kv_dequant_unpack_plain(c[:, idx], sc[:, idx], dt).reshape(g.shape)
                one = KV.kv_gather_dequant(c, sc, tables, dt)
                for what, x in (("kv_gather_dequant_kv", g), ("kv_gather_dequant", one)):
                    if not torch.equal(bit_pattern(torch, x), bit_pattern(torch, want)):
                        raise AssertionError(
                            f"{what} {name} {dt} tables {tuple(tables.shape)}: differ at "
                            f"{int((bit_pattern(torch, x) != bit_pattern(torch, want)).sum())} "
                            f"places")
                del want, one
            del got
    del leaves
    for m, kh in ((4096, 256), (1000, 48), (5, 2 * KV.TILE + 64),
                  (L * n_pages * PAGE_SIZE * Hkv, hd // 2)):
        flat_c, flat_s = every_pair(torch, (m, kh), (m, kh // 16), 5, device)
        for dt in (torch.float32, torch.bfloat16):
            got = KV.kv_dequant_unpack(flat_c, flat_s, dt)
            want = KV.kv_dequant_unpack_plain(flat_c, flat_s, dt)
            if not torch.equal(bit_pattern(torch, got), bit_pattern(torch, want)):
                raise AssertionError(f"kv_dequant_unpack [{m}, {kh}] {dt}: differs from its "
                                     f"plain version")


def check_kv_and_flash(torch, cfg, tcfg, device="cuda"):
    """B4a, B4b and B6 against their plain versions on the card; raises on a
    mismatch.  Returns {kernel: max abs error}."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kv_pack as KV

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    err = {}

    # B4a, bit-exact: the 2-d form on a [4096, 1024] block and the E8M0 edge
    # sweep; the one-launch K+V scatter at a decode write (8 tokens) and a
    # prefill write (8 x 64 tokens) of the engine, one layer's leaves (as
    # scatter_token passes them) and all layers' (as scatter_tokens does), K
    # a strided slice of a dense cache (as the gather backend passes it), V
    # holding the E8M0 edge rows; the one-leaf form at a decode write
    edge = torch.from_numpy(kv_edge_rows(np)).to(device)
    blocks = [("x[4096,1024] bf16", torch.randn((4096, 1024), generator=gen, device=device)
               .mul_(1.7).to(torch.bfloat16)), ("edge sweep f32", edge)]
    for name, x in blocks:
        for g, w_, what in zip(KV.kv_quant_pack(x), KV.kv_quant_pack_plain(x), ("codes", "scales")):
            if not torch.equal(g, w_):
                raise AssertionError(f"kv_quant_pack {name}: {what} differ at "
                                     f"{int((g != w_).sum())} places")
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    edge = edge.reshape(-1, hd).to(torch.bfloat16)
    for n_tok, layers in ((N_SLOTS, 1), (N_SLOTS * PREFILL_CHUNK, 1), (N_SLOTS, L),
                          (N_SLOTS * PREFILL_CHUNK, L)):
        shape = (layers, n_pages, PAGE_SIZE, Hkv)
        pools = [[torch.zeros((*shape, w), dtype=torch.uint8, device=device)
                  for w in (hd // 2, hd // 32, hd // 2, hd // 32)] for _ in range(2)]
        perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen, device=device)[:n_tok]
        pid = (1 + perm // PAGE_SIZE).to(torch.int32)
        off = (perm % PAGE_SIZE).to(torch.int32)
        cache = (torch.randn((layers, 2, n_tok + 5, Hkv, hd), generator=gen, device=device)
                 * 1.5).to(torch.bfloat16)
        k = cache[:, 1, 3:3 + n_tok]
        v = (torch.randn((layers, n_tok, Hkv, hd), generator=gen, device=device) * 1.5
             ).to(torch.bfloat16)
        rows = min(edge.shape[0], v.numel() // hd)
        v.view(-1, hd)[:rows] = edge[:rows]
        if layers == 1:
            KV.kv_quant_scatter_kv(*(t[0] for t in pools[0]), pid, off, k[0], v[0])
        else:
            KV.kv_quant_scatter_kv(*pools[0], pid, off, k, v)
        plain_quant_scatter(torch, pools[1][0], pools[1][1], pid, off, k)
        plain_quant_scatter(torch, pools[1][2], pools[1][3], pid, off, v)
        if n_tok == N_SLOTS and layers == 1:
            one = [torch.zeros_like(t) for t in pools[0][:2]]
            KV.kv_quant_scatter(one[0][0], one[1][0], pid, off, v[0])
            pools[0] += one
            pools[1] += pools[1][2:]
        for g, w_, what in zip(pools[0], pools[1], ("K codes", "K scales", "V codes", "V scales",
                                                    "codes (one leaf)", "scales (one leaf)")):
            if not torch.equal(g, w_):
                raise AssertionError(f"kv_quant_scatter_kv {n_tok} tokens x {layers} layers: "
                                     f"{what} differ at {int((g != w_).sum())} places")
    err["kv_quant_pack"] = 0.0

    check_gather_dequant(torch, cfg, gen, device)
    err["kv_dequant_unpack"] = 0.0

    # B6: f32 to atol 2e-5 (another summation order and expf); bf16 to one
    # bf16 rounding step, |Δ| <= 1e-5 + 2^-7·|plain|.  SDPA is a second
    # reading only.
    worst, readings = 0.0, {}
    for name, B, S, T, hq, hkv, d, causal, dtn in flash_shapes(cfg, tcfg):
        dt = getattr(torch, dtn)
        q = torch.randn((B, S, hq, d), generator=gen, device=device).to(dt)
        k, v = (torch.randn((B, T, hkv, d), generator=gen, device=device).to(dt)
                for _ in range(2))
        got = FA.mha_flash(q, k, v, causal=causal).float()
        want = flash_plain(FA, q, k, v, causal).float()
        rtol, atol = (0.0, 2e-5) if dt == torch.float32 else (2**-7, 1e-5)
        diff = (got - want).abs()
        bad = diff > atol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: {int(bad.sum())} elements off, "
                                 f"max |Δ| {float(diff.max())}")
        lib = sdpa(torch, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal).transpose(1, 2).float()
        readings[name] = {"max_abs_vs_plain": float(diff.max()),
                          "max_abs_vs_sdpa": float((got - lib).abs().max())}
        worst = max(worst, float(diff.max()))
        del q, k, v, got, want, lib
    log(f"  flash_attention vs plain and vs SDPA (second reading): {json.dumps(readings)}")
    err["flash_attention"] = worst
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------


def _count_step_calls(eng) -> dict:
    """Count the engine's step calls by kind (decode_all, prefill_all,
    prefill_chunk) by wrapping its steps."""
    calls = {}

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    eng._steps = eng._steps._replace(**{n: wrap(n, f) for n, f in eng._steps._asdict().items()
                                        if f is not None})
    return calls


def gather_schedule(prompt_lens, max_new: int, chunk: int) -> tuple[int, int]:
    """(prefill calls, decode ticks) of the gather engine when every request
    is admitted at the first step: each tick a prefilling slot runs one
    [1, chunk] call, or all of its remaining tokens as [1, 1] calls and then
    takes its first token; every tick with a decoding slot is one decode
    call, which gives each decoding slot one token."""
    pos, made = [0] * len(prompt_lens), [0] * len(prompt_lens)
    calls = ticks = 0
    while any(m < max_new for m in made):
        for i, n in enumerate(prompt_lens):
            if pos[i] < n:
                step = chunk if n - pos[i] >= chunk else n - pos[i]
                calls += 1 if step == chunk else step
                pos[i] += step
                if pos[i] == n:
                    made[i] = 1
        decoding = [i for i, n in enumerate(prompt_lens) if pos[i] == n and 0 < made[i] < max_new]
        ticks += bool(decoding)
        for i in decoding:
            made[i] += 1
    return calls, ticks


def serve_full_width(torch, ops, device="cuda"):
    """8 requests on full-width, full-depth qwen3-1.7b through the engine
    (paged backend), then the first GATHER_REQUESTS of them on the gather
    backend.  Returns (summary, launch counts of the paged run, gather
    summary, launch counts of the gather run)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig

    cfg = kernel_config(get_config("qwen3-1.7b"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the engine's own peak, not the checks'
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    log(f"  init: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
        f"in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]

    def run(keep_logits: bool, backend: str = "paged", prompts=prompts, max_new=MAX_NEW):
        eng = Engine(model, params, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE, kv_dtype="mxfp4",
            prefill_chunk=PREFILL_CHUNK, keep_logits=keep_logits, decode_backend=backend))
        calls = _count_step_calls(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new, arrival_time=0.0) for p in prompts]
        first, ticks = {}, {"prefill": [], "decode": []}
        while eng.sched.pending:
            kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
            s0 = time.perf_counter()
            eng.step(now=s0 - t0)
            ticks[kind].append(time.perf_counter() - s0)  # ends in a host read
            for r in reqs:
                if r.tokens and r.rid not in first:
                    first[r.rid] = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in reqs:
            if len(r.tokens) != max_new or r.finish_reason != "max_tokens":
                raise AssertionError(f"{backend} request {r.rid} finished with "
                                     f"{len(r.tokens)} tokens ({r.finish_reason!r})")
            for row in r.logits_trace:
                if row.shape != (cfg.vocab_size,) or not np.isfinite(row).all():
                    raise AssertionError(f"{backend} request {r.rid}: non-finite or "
                                         f"misshapen logits")
            if not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"{backend} request {r.rid}: token out of range")
        return eng, reqs, wall, first, ticks, calls

    L = cfg.num_layers
    run(False)  # warm-up: first-use costs (allocator, library handles)
    ops.reset_launch_counts()
    eng, reqs, wall, _, _, calls = run(True)
    counts = ops.launch_counts()
    vec = ops.vector_launches()
    # per forward (one step call): 2 B1 and 1 B3 in each of the 7 quantized
    # linears of a layer (the tied lm-head stays bf16), 1 B5 and 1 B4a (K and
    # V in one launch) per layer
    n = sum(calls.values())
    predicted = {"hadamard_quest_quantize": 14 * L * n, "mxfp4_matmul": 7 * L * n,
                 "paged_attention": L * n, "kv_quant_pack": L * n}
    predicted = {k: predicted.get(k, 0) for k in counts}
    log(f"  main-path run: {len(reqs)} requests x {MAX_NEW} tokens, prompts "
        f"{[int(p.size) for p in prompts]}, {eng.steps} steps, step calls {calls}, "
        f"{wall:.3f} s (logits copied to the host for the checks)")
    if counts != predicted:
        raise AssertionError(f"paged run launches {counts} != predicted {predicted}")
    paged_reqs = reqs
    _, reqs, wall, first, ticks, _ = run(False)
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"requests": len(reqs), "tokens": toks, "wall_s": wall,
               "tok_per_s": toks / wall, "ttft_mean_s": float(np.mean(ttft)),
               "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "step_calls": calls, "predicted_launches": predicted,
               "vector_launches": vec,
               "kv_pool_bytes": eng.cache_bytes(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    # the gather backend at full width: per-slot prefill ([1, 64] chunks,
    # then [1, 1] remainders), decode over the gathered dense view
    g_prompts = prompts[:GATHER_REQUESTS]
    ops.reset_launch_counts()
    geng, greqs, gwall, gfirst, _, gcalls = run(True, "gather", g_prompts, GATHER_NEW)
    gcounts = ops.launch_counts()
    gvec = ops.vector_launches()
    n_pre, n_dec = gather_schedule([p.size for p in g_prompts], GATHER_NEW, PREFILL_CHUNK)
    if gcalls != {"prefill_chunk": n_pre, "decode_all": n_dec}:
        raise AssertionError(f"gather step calls {gcalls} != predicted "
                             f"{{'prefill_chunk': {n_pre}, 'decode_all': {n_dec}}}")
    # per forward: 14 B1 and 7 B3 per layer as above; per step call one
    # gather (1 B4b, all layers, K and V) and one scatter (1 B4a, all
    # layers, K and V)
    n = n_pre + n_dec
    gpredicted = {"hadamard_quest_quantize": 14 * L * n, "mxfp4_matmul": 7 * L * n,
                  "kv_quant_pack": n, "kv_dequant_unpack": n}
    gpredicted = {k: gpredicted.get(k, 0) for k in gcounts}
    if gcounts != gpredicted:
        raise AssertionError(f"gather run launches {gcounts} != predicted {gpredicted}")
    # first-token log-probs of gather against paged, held to max |Δ| < 5.0
    # and mean |Δ| < 1.0: twice the reference test's bound for an MXFP4 pool
    # against unquantized K/V (2.5, 0.5), because the two backends quantize
    # different K/V and each may sit that far from the unquantized forward.
    # A gather prefill call attends over its own chunk's K/V before
    # quantization and the earlier chunks' after it; the paged one quantizes
    # each chunk before it attends; and the two chunk a prompt differently
    # ([1, 64] + [1, 1] calls vs [8, 64] ticks).  Each backend against the
    # teacher-forced forward of the prompt is printed beside, as a reading.
    def logp(row):
        return torch.log_softmax(torch.as_tensor(row).float().cpu(), -1)

    lp, tf = [], {"paged": [], "gather": []}
    with torch.inference_mode():
        for p, g, p_ in zip(g_prompts, greqs, paged_reqs):
            feats, _ = model.forward(params, torch.from_numpy(p)[None].to(device), 0,
                                     features_only=True)
            ref = logp(model.head(params, feats[:, -1:], 0)[0, 0])
            for name, r in (("paged", p_), ("gather", g)):
                d = (logp(r.logits_trace[0]) - ref).abs()
                tf[name].append((float(d.max()), float(d.mean())))
            d = (logp(g.logits_trace[0]) - logp(p_.logits_trace[0])).abs()
            lp.append((float(d.max()), float(d.mean())))
    agree = [sum(int(x == y) for x, y in zip(g.tokens, p_.tokens[:GATHER_NEW]))
             for g, p_ in zip(greqs, paged_reqs)]
    gttft = sorted(gfirst.values())
    gtoks = sum(len(r.tokens) for r in greqs)
    gsummary = {"requests": len(greqs), "prompts": [int(p.size) for p in g_prompts],
                "tokens": gtoks, "wall_s": gwall, "tok_per_s": gtoks / gwall,
                "ttft_mean_s": float(np.mean(gttft)), "ttft_max_s": gttft[-1],
                "steps": geng.steps, "step_calls": gcalls, "predicted_launches": gpredicted,
                "vector_launches": gvec,
                "first_token_logprob_max_abs_vs_paged": [x for x, _ in lp],
                "first_token_logprob_mean_abs_vs_paged": [y for _, y in lp],
                "first_token_logprob_vs_teacher_forced": tf,
                "tokens_agreeing_with_paged": agree}
    log(f"  gather run: {json.dumps(gsummary)} (logits copied to the host for the checks)")
    if not all(x < 5.0 and y < 1.0 for x, y in lp):
        raise AssertionError(f"gather vs paged first-token log-probs out of tolerance: {lp}")
    del params
    torch.cuda.empty_cache()
    return summary, counts, gsummary, gcounts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_reduced_engine(torch, device="cuda"):
    """The repo's token oracle at a small size on the card: under the bf16
    method with a dense pool the engine's greedy tokens equal the argmax of
    its own teacher-forced forward (f32 model) on the paged backend, and the
    gather backend's tokens equal the paged backend's; with the MXFP4 pool
    and the Quartet kernels its first-token log-probs stay within the
    reference test's bound of the teacher-forced ones."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig

    cfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (7, 19, 33)]
    tokens = {}
    for kv, method, backend in (("dense", "bf16", "paged"), ("dense", "bf16", "gather"),
                                ("mxfp4", "quartet", "paged")):
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48, page_size=8,
                                                 kv_dtype=kv, prefill_chunk=8,
                                                 method=method, keep_logits=True,
                                                 decode_backend=backend))
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        tokens[backend, kv] = [r.tokens for r in reqs]
        for p, r in zip(prompts, reqs):
            seq = torch.tensor(np.concatenate([p, r.tokens[:-1]])[None], device=device)
            tf, _ = model.forward(params, seq, 0, method=method)
            tf = tf[0, p.size - 1:].float().cpu()
            if kv == "dense":
                if r.tokens != tf.argmax(-1).tolist():
                    raise AssertionError(f"reduced engine tokens {r.tokens} != "
                                         f"teacher-forced argmax {tf.argmax(-1).tolist()}")
            else:
                d = (torch.log_softmax(tf[0], -1)
                     - torch.log_softmax(torch.from_numpy(r.logits_trace[0]), -1)).abs()
                if float(d.max()) >= 2.5 or float(d.mean()) >= 0.5:
                    raise AssertionError(f"mxfp4 engine log-probs off by max {float(d.max())}")
    if tokens["gather", "dense"] != tokens["paged", "dense"]:
        raise AssertionError(f"reduced engine: gather tokens {tokens['gather', 'dense']} != "
                             f"paged tokens {tokens['paged', 'dense']}")
    log("  reduced engine: dense/bf16 tokens == teacher-forced argmax on both backends "
        "(gather == paged); mxfp4/quartet first-token log-probs within bound")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def time_kernels(torch, cfg, timer, device="cuda"):
    """Each kernel over one layer's decode-step launches (8 slots), beside its
    plain version, its least time on the H100 and, where one exists, one
    PyTorch call computing the same function.  Also one prefill chunk's."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rec = {}
    for m, tag in ((N_SLOTS, "decode"), (N_SLOTS * PREFILL_CHUNK, "prefill")):
        xs, ws, qa, qw = [], [], [], []
        for _, K, N in linear_shapes(cfg):
            xs.append(torch.randn((m, K), generator=gen, device=device).to(torch.bfloat16))
            ws.append((torch.randn((K, N), generator=gen, device=device) / K**0.5)
                      .to(torch.bfloat16))
            qa.append(HQ.hadamard_quest_quantize(xs[-1]))
            qw.append(HQ.hadamard_quest_quantize(ws[-1].t()))

        def hq(fn):
            return lambda: [fn(t) for pair in zip(xs, ws) for t in (pair[0], pair[1].t())]

        def hq_bytes(ts):  # 2 B read, 1 B code and 1 B mask written per element
            return sum(t.numel() * (2 + 2) + t.numel() // 32 * 4 for t in ts)

        rec[("hadamard_quest_quantize", tag)] = dict(
            ms=timer(hq(HQ.hadamard_quest_quantize)),
            device_ms=timer.device(hq(HQ.hadamard_quest_quantize)),
            plain_ms=timer(hq(HQ.hadamard_quest_quantize_plain)),
            bound_ms=hq_bytes(xs + ws) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, launches_per_layer=2 * len(xs))
        # the same layer's calls apart: the 7 weight views (device time) and
        # the 7 activations (small: the wrapper's host time)
        for part, ts in (("weights", [w.t() for w in ws]), ("activations", xs)):
            rec[("hadamard_quest_quantize", f"{tag} {part}")] = dict(
                ms=timer(lambda ts=ts: [HQ.hadamard_quest_quantize(t) for t in ts]),
                device_ms=timer.device(lambda ts=ts: [HQ.hadamard_quest_quantize(t) for t in ts]),
                plain_ms=timer(lambda ts=ts: [HQ.hadamard_quest_quantize_plain(t) for t in ts]),
                bound_ms=hq_bytes(ts) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, launches_per_layer=len(ts))

        args = [(a[0], a[1], w[0].t(), w[1].t()) for a, w in zip(qa, qw)]
        deq = [(_deq(torch, a[0], a[1]).to(torch.bfloat16),
                _deq(torch, w[0], w[1]).to(torch.bfloat16).t()) for a, w in zip(qa, qw)]
        nbytes = sum(a.numel() * 1 + s.numel() * 4 + b.numel() + t.numel() * 4
                     + a.shape[0] * b.shape[1] * 4 for a, s, b, t in args)
        nops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, _, b, _ in args)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS) * 1e3
        rec[("mxfp4_matmul", tag)] = dict(
            ms=timer(lambda: [MM.mxfp4_matmul(*a) for a in args]),
            device_ms=timer.device(lambda: [MM.mxfp4_matmul(*a) for a in args]),
            plain_ms=timer(lambda: [MM.mxfp4_matmul_plain(*a) for a in args]),
            bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_INT8_OPS
            else "operations",
            library_ms=timer(lambda: [torch.matmul(a, b) for a, b in deq]),
            launches_per_layer=len(args))

        S = 1 if tag == "decode" else PREFILL_CHUNK
        lengths = [MIN_PROMPT + (MAX_PROMPT + MAX_NEW - MIN_PROMPT) * i // (N_SLOTS - 1)
                   for i in range(N_SLOTS)]
        lens = [max(n - S + 1, 1) for n in lengths]
        pool, tables = make_pool(torch, cfg, [n + S - 1 for n in lens], True, torch.bfloat16,
                                 gen, device, MAX_LEN // PAGE_SIZE + 1)
        q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                        device=device).to(torch.bfloat16)
        ln = torch.tensor(lens, dtype=torch.int32, device=device)
        nbytes, nops = attention_bytes_ops(cfg, lens, S, True, 2)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_BF16_OPS) * 1e3
        lib = _sdpa_operands(torch, cfg, q, pool, tables, ln)
        rec[("paged_attention", tag)] = dict(
            ms=timer(lambda: PA.paged_attention(q, pool, tables, ln)),
            device_ms=timer.device(lambda: PA.paged_attention(q, pool, tables, ln)),
            plain_ms=timer(lambda: PA.paged_attention_plain(q, pool, tables, ln)),
            bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_BF16_OPS
            else "operations",
            library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(*lib)),
            launches_per_layer=1)
    return rec


def time_kv_and_flash(torch, cfg, tcfg, timer, device="cuda"):
    """B4a over one layer's KV write (``scatter_token``: K and V) of a decode
    tick (8 tokens) and a prefill tick (8 x 64 tokens); B4b over one decode
    tick's gather (``gather_pages``: K and V, 28 layers, 8 slots x 640
    positions, bf16 out); B6
    at the evaluation shape and at qwen3-1.7b's GQA at 4096.  Each beside its
    plain version, its least time on the H100 and, for B6, one SDPA call."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.kernels.paged_attention import scatter_token
    from repro_torch.serve.paged_cache import gather_pages

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    rec = {}
    pool = {n: torch.zeros((n_pages, PAGE_SIZE, Hkv, w), dtype=torch.uint8, device=device)
            for n, w in (("k_codes", hd // 2), ("k_scales", hd // 32), ("v_codes", hd // 2),
                         ("v_scales", hd // 32))}
    for n_tok, tag in ((N_SLOTS, "decode"), (N_SLOTS * PREFILL_CHUNK, "prefill")):
        perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen, device=device)[:n_tok]
        pid = (1 + perm // PAGE_SIZE).to(torch.int32)
        off = (perm % PAGE_SIZE).to(torch.int32)
        k, v = [(torch.randn((n_tok, Hkv, hd), generator=gen, device=device) * 1.5)
                .to(torch.bfloat16) for _ in range(2)]
        # K and V: 2 B read per bf16 element, 0.5 + 1/32 B written; 8 B of
        # ids per token
        nbytes = 2 * n_tok * Hkv * hd * (2 + 0.5 + 1 / 32) + 8 * n_tok
        before = KV.kv_quant_pack.launches
        scatter_token(pool, pid, off, k, v)
        per_write = KV.kv_quant_pack.launches - before

        def plain():
            for x, c, sc in ((k, "k_codes", "k_scales"), (v, "v_codes", "v_scales")):
                plain_quant_scatter(torch, pool[c][None], pool[sc][None], pid, off, x[None])

        rec[("kv_quant_pack", tag)] = dict(
            ms=timer(lambda: scatter_token(pool, pid, off, k, v)),
            device_ms=timer.device(lambda: scatter_token(pool, pid, off, k, v)),
            plain_ms=timer(plain),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
            launches_per_layer=per_write)
    del pool

    # B4b through the gather backend's entry point (gather_pages: K and V)
    pool = {n: torch.randint(0, 256, (L, n_pages, PAGE_SIZE, Hkv, w), generator=gen,
                             device=device, dtype=torch.uint8)
            for n, w in (("k_codes", hd // 2), ("k_scales", hd // 32), ("v_codes", hd // 2),
                         ("v_scales", hd // 32))}
    pool["k_scales"].clamp_(100, 154)
    pool["v_scales"].clamp_(100, 154)
    tables = (1 + torch.arange(n_pages - 1, device=device, dtype=torch.int32)
              ).reshape(N_SLOTS, -1)
    n_el = L * tables.numel() * PAGE_SIZE * Hkv * hd
    # per K and V: 0.5 + 1/32 B read and 2 B (bf16) written per element
    nbytes = 2 * n_el * (0.5 + 1 / 32 + 2) + 4 * tables.numel()
    idx = tables.long()
    before = KV.kv_dequant_unpack.launches
    gather_pages(pool, tables, torch.bfloat16)
    per_tick = KV.kv_dequant_unpack.launches - before
    rec[("kv_dequant_unpack", "gather")] = dict(
        ms=timer(lambda: gather_pages(pool, tables, torch.bfloat16)),
        device_ms=timer.device(lambda: gather_pages(pool, tables, torch.bfloat16)),
        plain_ms=timer(lambda: [KV.kv_dequant_unpack_plain(pool[c][:, idx], pool[sc][:, idx],
                                                           torch.bfloat16)
                                for c, sc in (("k_codes", "k_scales"), ("v_codes", "v_scales"))]),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
        launches_per_tick=per_tick)
    del pool

    for name, B, S, T, hq, hkv, d, causal, dtn in flash_shapes(cfg, tcfg)[:2]:
        dt = getattr(torch, dtn)
        q = torch.randn((B, S, hq, d), generator=gen, device=device).to(dt)
        k, v = (torch.randn((B, T, hkv, d), generator=gen, device=device).to(dt)
                for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        nops = 4 * B * hq * S * T * d * (0.5 if causal else 1.0)
        nbytes = 2 * (2 * B * S * hq * d + 2 * B * T * hkv * d)
        by_ops, by_bytes = nops / H100_BF16_OPS, nbytes / H100_BYTES_PER_S
        rec[("flash_attention", name)] = dict(
            ms=timer(lambda: FA.mha_flash(q, k, v, causal=causal)),
            plain_ms=timer(lambda: flash_plain(FA, q, k, v, causal)),
            bound_ms=max(by_ops, by_bytes) * 1e3,
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            library_ms=timer(lambda: sdpa(torch, qt, kt, vt, causal)),
            launches_per_layer=1)
        del q, k, v, qt, kt, vt
    return rec


def _deq(torch, codes, scales):
    m, k = codes.shape
    return (codes.float().reshape(m, k // 32, 32) * (0.5 * scales)[..., None]).reshape(m, k)


def _sdpa_operands(torch, cfg, q, pool, tables, lengths):
    """q, K, V, mask for one SDPA call over the gathered, dequantized KV
    (GQA heads expanded), outside the timed call."""
    from repro_torch.serve.paged_cache import gather_pages

    one = {k: v[None] for k, v in pool.items()}
    k, v = gather_pages(one, tables, q.dtype)
    k, v = k[0], v[0]  # [B, T, Hkv, hd]
    g = cfg.num_heads // cfg.num_kv_heads
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    S = q.shape[1]
    qq = q.transpose(1, 2).contiguous()  # [B, Hq, S, hd]
    T = k.shape[2]
    qpos = lengths.long()[:, None] - 1 + torch.arange(S, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None] <= qpos[..., None]
    return qq, k, v, mask[:, None]

# ---------------------------------------------------------------------------
# phase 2b: the training kernels at full width
# ---------------------------------------------------------------------------


class PlainOps:
    """The kernels' plain versions behind ``kernels.ops``'s signatures, so
    the kernel-path Quartet passes can run on them on the card."""

    def __init__(self):
        from repro_torch.kernels import hadamard_quant as HQ
        from repro_torch.kernels import mxfp4_matmul as MM
        from repro_torch.kernels import sr_hadamard_quant as SR

        self.HQ, self.MM, self.SR = HQ, MM, SR

    def hadamard_quest_quantize(self, x, group=32):
        lead = x.shape[:-1]
        out = self.HQ.hadamard_quest_quantize_plain(x.reshape(-1, x.shape[-1]))
        return tuple(t.reshape(*lead, -1) for t in out)

    def sr_hadamard_quantize(self, x, signs, seed, prescale=0.75, salt=0):
        return self.SR.sr_hadamard_quantize_plain(x, signs, seed, prescale, salt)

    def mxfp4_matmul(self, a, sa, b, sb):
        lead = a.shape[:-1]
        out = self.MM.mxfp4_matmul_plain(a.reshape(-1, a.shape[-1]),
                                          sa.reshape(-1, sa.shape[-1]), b, sb)
        return out.reshape(*lead, -1)


def backward_operands(torch, K, N, gen, device="cuda"):
    """The four backward Stage-1 operands of one full-width linear [K, N]
    over one microbatch, as ``quartet._backward_kernels`` passes them:
    dy [T, N] (bf16, row-major), and three views with unit stride along
    their rows: the dequantized weight Wq [K, N] (f32, the transpose of the
    [N, K] codes' values), xqᵀ [K, T] (f32) and dyᵀ [N, T] (bf16)."""
    from repro_torch.core.quartet import _dequant_codes
    from repro_torch.kernels import hadamard_quant as HQ

    T = TRAIN_TOKENS_MB
    x = torch.randn((T, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
    dy = (torch.randn((T, N), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    xc, xs, _ = HQ.hadamard_quest_quantize(x)
    wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
    return {"dy": dy, "Wq": _dequant_codes(wc, ws, 32).t(),
            "xqᵀ": _dequant_codes(xc, xs, 32).t(), "dyᵀ": dy.t()}


def check_training_kernels(torch, cfg, device="cuda"):
    """Training-shape checks on the card (full-width llama-paper-200m, one
    microbatch of 16 x 512 tokens); raises on a mismatch.  Returns the max
    abs error of each kernel and of the whole backward."""
    from repro_torch.core import fastrng
    from repro_torch.core.quartet import QuartetConfig, _backward_kernels, _forward_kernels
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    seed = 12345
    err = {}
    # sr_hadamard_quantize: the four operands of the up projection (K 1280,
    # N 3456) and of the down projection (K 3456, N 1280), codes and scales
    # bit-exact, at the training path's layouts (three of them views with
    # unit stride along M)
    d, f = cfg.d_model, cfg.d_ff
    codes = {}
    for proj, K, N in (("up", d, f), ("down", f, d)):
        for salt, (name, x) in enumerate(backward_operands(torch, K, N, gen, device).items(), 1):
            signs = fastrng.rademacher(seed, x.shape[1], salt=11 if salt < 3 else 12,
                                       device=device)
            got = SR.sr_hadamard_quantize(x, signs, seed, salt=salt)
            want = SR.sr_hadamard_quantize_plain(x, signs, seed, salt=salt)
            for g, w_, what in zip(got, want, ("codes", "scales")):
                if not torch.equal(g, w_):
                    raise AssertionError(f"sr_hadamard_quantize {proj} {name} {tuple(x.shape)} "
                                         f"(strides {x.stride()}): {what} differ at "
                                         f"{int((g != w_).sum())} places")
            codes[proj, name] = got
    err["sr_hadamard_quantize"] = 0.0

    # mxfp4_matmul at the backward's operand layouts: dx [T, N]·[N, K] and
    # dW [K, T]·[T, N] with B the transposed view of the SR codes, and the
    # down projection's dW (M = d_ff rows, 8192-token contraction)
    def gemm(a, b):
        return (*codes[a], codes[b][0].t(), codes[b][1].t())

    cases = {"dx": gemm(("up", "dy"), ("up", "Wq")), "dW": gemm(("up", "xqᵀ"), ("up", "dyᵀ")),
             "dW down": gemm(("down", "xqᵀ"), ("down", "dyᵀ"))}
    worst = 0.0
    for name, args in cases.items():
        got, want = MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args)
        diff = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"mxfp4_matmul {name} {tuple(args[0].shape)} x "
                                 f"{tuple(args[2].shape)}: max |Δ| {diff}")
        worst = max(worst, diff)
    err["mxfp4_matmul"] = worst

    # one full-width quartet_linear backward (the up projection) on the
    # kernels against the same backward on the plain versions
    qc = QuartetConfig(use_kernels=True)
    x = torch.randn((TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, d), generator=gen,
                    device=device).to(torch.bfloat16)
    w = (torch.randn((d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    dy = (torch.randn((*x.shape[:-1], f), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    _, res = _forward_kernels(x, w, qc)
    dx, dw = _backward_kernels(qc, seed, res, dy)
    pdx, pdw = _backward_kernels(qc, seed, res, dy, ops=PlainOps())
    for name, a, b in (("dx", dx, pdx), ("dW", dw, pdw)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max())):
            raise AssertionError(f"quartet_linear backward {name}: kernels vs plain max |Δ| "
                                 f"{float((a - b).abs().max())} (max |plain| "
                                 f"{float(b.abs().max())})")
    err["quartet_linear backward"] = max(float((dx - pdx).abs().max()),
                                         float((dw - pdw).abs().max()))
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def train_reduced_card_vs_cpu(torch, device="cuda"):
    """A reduced Llama (f32) 3 steps on the card with the kernels and on the
    CPU with the plain versions, from the same weights and batches.  Returns
    the max relative differences of loss and grad-norm.

    Tolerance.  Step 0 (same weights, same batch): loss rtol 1e-5, grad-norm
    rtol 1e-3.  Every step: loss rtol 8e-3, grad-norm rtol 3e-2, about twice
    the largest differences this seeded run shows on an H100 (3.84e-3 and
    1.41e-2, the same on every machine).  The kernels equal their plain
    versions bit for bit, but the rest of the step (norms, attention, the
    loss) rounds differently on the card, so now and then a
    stochastic-rounding decision flips and moves one gradient column by a
    grid step; AdamW's first steps follow the sign of each gradient element,
    so the next losses drift apart by a few parts in a thousand."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.tree import tree_map

    cfg = kernel_config(get_reduced_config(TRAIN_ARCH, dtype="float32"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), 8, 64)
    hist = {}
    for dev in (device, "cpu"):
        _, hist[dev] = train(model, adamw(cosine_warmup(1e-3, 3)), batcher, 3,
                             microbatch=2, params=tree_map(lambda t: t.to(dev), params),
                             device=dev, log_fn=lambda *_: None)
    rel, bad = {}, []
    for key, tol0, tol in (("loss", 1e-5, 8e-3), ("grad_norm", 1e-3, 3e-2)):
        a = [h[key] for h in hist[device]]
        b = [h[key] for h in hist["cpu"]]
        r = [abs(x - y) / abs(y) for x, y in zip(a, b)]
        rel[key] = r
        log(f"  reduced {key}: card {a} cpu {b} (rel {r}; tolerance {tol0} at step 0, "
            f"{tol} at every step)")
        if not (r[0] <= tol0 and max(r) <= tol):
            bad.append(key)
    if bad:
        raise AssertionError(f"reduced training: {bad} on the card vs the CPU out of tolerance")
    return rel


def train_full_width(torch, ops, device="cuda"):
    """Full-width, full-depth llama-paper-200m through ``train.loop.train``:
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MICRO
    microbatches, Quartet on every transformer linear through the kernels.
    Returns (summary, launch counts of the run)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.train.steps import make_eval_step

    cfg = kernel_config(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    n_params = sum(p.numel() for p in _leaves(params))
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), TRAIN_BATCH,
                           TRAIN_SEQ)
    opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(model, opt, batcher, TRAIN_STEPS, microbatch=TRAIN_MICRO,
                        params=params, device=device, log_every=1,
                        log_fn=lambda m: log("  " + m))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    vec = ops.vector_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    # the loss after the last step, on step 0's batch (the step losses are
    # each on their own batch, which differ by more than 5 steps move them)
    batch0 = {k: torch.from_numpy(v).to(device) for k, v in batcher.batch(0).items()}
    after = float(make_eval_step(model)(state.params, batch0)["nll"])
    if not all(math.isfinite(v) for v in losses + gnorms + [after]):
        raise AssertionError(f"non-finite training metrics: loss {losses}, gnorm {gnorms}, "
                             f"after {after}")
    if not after < losses[0]:
        raise AssertionError(f"loss on step 0's batch did not fall over {TRAIN_STEPS} steps: "
                             f"{losses[0]} -> {after}")
    # remat: each microbatch runs every quantized linear's forward twice
    # (2 B1 + 1 B3 each) and its backward once (4 B2 + 2 B3); the untied
    # lm-head stays bf16 and launches none
    linears = cfg.num_layers * 7
    per_mb = {"hadamard_quest_quantize": 4 * linears, "sr_hadamard_quantize": 4 * linears,
              "mxfp4_matmul": 4 * linears, "paged_attention": 0}
    predicted = {k: v * TRAIN_MICRO * TRAIN_STEPS for k, v in per_mb.items()}
    dts = sorted(h["dt"] for h in hist)
    med = dts[len(dts) // 2]
    summary = {"arch": TRAIN_ARCH, "params": n_params, "steps": TRAIN_STEPS,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
               "loss": losses, "loss_after_on_batch0": after, "grad_norm": gnorms,
               "step_s": [h["dt"] for h in hist],
               "median_step_s": med, "tokens_per_s_median_step": TRAIN_BATCH * TRAIN_SEQ / med,
               "tokens_per_s_run": TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall,
               "wall_s": wall, "peak_mem_gb": peak,
               "launches": counts, "predicted_launches": predicted,
               "vector_launches": vec}
    summary["breakdown"] = profile_train_step(torch, model, opt, state, batcher, device)
    summary["eval"], eval_counts = evaluate_full_width(torch, ops, model, state, device)
    del state
    torch.cuda.empty_cache()
    return summary, counts, eval_counts


def evaluate_full_width(torch, ops, model, state, device="cuda"):
    """``train.loop.evaluate`` of the trained state over EVAL_BATCHES
    held-out batches of EVAL_BATCH x TRAIN_SEQ, once with the training model
    (blocked attention) and once built with ``attn_backend="flash"``, every
    launch counter set to 0 just before each.  Returns (summary, launch
    counts of the flash run).

    Tolerance: |nll_flash − nll_blocked| <= 0.01 nats.  The two attentions
    round differently (bf16 outputs of f32 sums in another order), and a
    one-ulp change upstream can flip a QuEST rounding decision (ROADMAP C1),
    which moves single logits; the mean over 32768 tokens moves far less."""
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.models import build_model
    from repro_torch.train.loop import evaluate

    cfg = model.cfg
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), EVAL_BATCH, TRAIN_SEQ)
    out, counts = {}, {}
    for backend, m in (("blocked", model), ("flash", build_model(cfg, attn_backend="flash"))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[f"nll_{backend}"] = evaluate(m, state, batcher, EVAL_BATCHES, device=device)
        out[f"wall_s_{backend}"] = time.perf_counter() - t0  # evaluate ends in host reads
        counts[backend] = ops.launch_counts()
        out[f"vector_launches_{backend}"] = ops.vector_launches()
    out["nll_diff"] = out["nll_flash"] - out["nll_blocked"]
    out["launches_blocked"], out["launches_flash"] = counts["blocked"], counts["flash"]
    log(f"  evaluation: {json.dumps(out)} (tolerance |Δnll| <= 0.01)")
    want = cfg.num_layers * EVAL_BATCHES
    if counts["flash"]["flash_attention"] != want or counts["blocked"]["flash_attention"]:
        raise AssertionError(f"flash_attention launches: flash-built {counts['flash']} "
                             f"(want {want}), blocked {counts['blocked']} (want 0)")
    if not (math.isfinite(out["nll_flash"]) and abs(out["nll_diff"]) <= 0.01):
        raise AssertionError(f"flash vs blocked evaluation nll out of tolerance: {out}")
    return out, counts["flash"]


KERNEL_NAMES = {"hadamard_quest_": "hadamard_quest_quantize",  # tile, rows and cols bodies
                "sr_hadamard_": "sr_hadamard_quantize",  # tile, rows and cols bodies
                "mxfp4_mma_kernel": "mxfp4_matmul", "paged_attention": "paged_attention"}


def _kind(name: str) -> str:
    for key, kernel in KERNEL_NAMES.items():
        if key in name:
            return kernel
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "library GEMM (lm-head, attention bmm, Hadamard epilogue)"
    return "other PyTorch kernels (elementwise, reductions, copies)"


def profile_train_step(torch, model, opt, state, batcher, device="cuda"):
    """Where one more full-width train step's time goes: device time by
    kernel kind from ``torch.profiler`` (kernels on one stream, so their
    sum over the step's wall time is the busy share), and, timed apart with
    a synchronised host clock, the lm-head + loss of one microbatch (forward
    and backward) and one AdamW update of all parameters."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import apply_updates
    from repro_torch.train.losses import chunked_lm_loss
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_map

    step_fn = make_train_step(model, opt, microbatch=TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batcher.batch(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + us / 1e3
    busy = sum(by_kind.values())
    out = {"profiled_step_ms": wall * 1e3, "device_ms_by_kind": by_kind,
           "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3)}

    def host_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    cfg = model.cfg
    cparams = tree_map(lambda p: p.to(torch.bfloat16), state.params)
    feats = torch.randn((TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, cfg.d_model), device=device,
                        dtype=torch.bfloat16, requires_grad=True)
    labels = batch["labels"][:TRAIN_BATCH // TRAIN_MICRO]

    def head():
        loss, _ = chunked_lm_loss(model.head, cparams, feats, labels, 0)
        loss.backward()

    out["lm_head_loss_fwd_bwd_ms_per_microbatch"] = host_ms(head)
    out["adamw_update_ms"] = host_ms(lambda: apply_updates(
        state.params, opt.update(state.params, state.opt_state, state.params)[0]))
    return out


def time_training_kernels(torch, cfg, timer, device="cuda"):
    """Each training kernel over the launches of one full-width linear (the
    up projection, K 1280, N 3456) in one microbatch of 16 x 512 tokens,
    beside its plain version, its least time and, where one exists, one
    PyTorch call computing the same function."""
    from repro_torch.core import fastrng
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    d, f, T = cfg.d_model, cfg.d_ff, TRAIN_TOKENS_MB
    rec = {}

    # forward Stage 1: x [T, K] and the Wᵀ view, bf16
    x = torch.randn((T, d), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    n = x.numel() + w.numel()
    rec[("hadamard_quest_quantize", "train")] = dict(
        ms=timer(lambda: (HQ.hadamard_quest_quantize(x), HQ.hadamard_quest_quantize(w.t()))),
        device_ms=timer.device(lambda: (HQ.hadamard_quest_quantize(x),
                                        HQ.hadamard_quest_quantize(w.t()))),
        plain_ms=timer(lambda: (HQ.hadamard_quest_quantize_plain(x),
                                HQ.hadamard_quest_quantize_plain(w.t()))),
        bound_ms=n * (2 + 1 + 1 + 4 / 32) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, launches_per_linear_fwd=2)

    # backward Stage 1: the four operands (each element read once at its
    # width, 2 B for dy and dyᵀ, 4 B for Wq and xqᵀ; written as a 1 B code
    # and 4/32 B of scale), and B2_F32_OPS + B2_INT32_OPS operations an
    # element, bound by the int32 work at H100_INT32_OPS or by all of it at
    # the issue rate H100_F32_OPS, whichever is longer
    opnds = backward_operands(torch, d, f, gen, device)
    signs = {k: fastrng.rademacher(7, v.shape[1], salt=11, device=device)
             for k, v in opnds.items()}
    nbytes = sum(v.numel() * (v.element_size() + 1 + 4 / 32) for v in opnds.values())
    n_el = sum(v.numel() for v in opnds.values())
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = max(n_el * B2_INT32_OPS / H100_INT32_OPS,
                 n_el * (B2_F32_OPS + B2_INT32_OPS) / H100_F32_OPS)

    def sr(fn):
        return lambda: [fn(v, signs[k], 7, 0.75, i) for i, (k, v) in enumerate(opnds.items(), 1)]

    rec[("sr_hadamard_quantize", "train")] = dict(
        ms=timer(sr(SR.sr_hadamard_quantize)),
        device_ms=timer.device(sr(SR.sr_hadamard_quantize)),
        plain_ms=timer(sr(SR.sr_hadamard_quantize_plain)),
        bound_ms=max(by_bytes, by_ops) * 1e3, bytes_ms=by_bytes * 1e3, ops_ms=by_ops * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        device_ms_by_operand={k: timer.device(lambda k=k, i=i, v=v: SR.sr_hadamard_quantize(
            v, signs[k], 7, 0.75, i)) for i, (k, v) in enumerate(opnds.items(), 1)},
        library_ms=None, launches_per_linear_bwd=4)

    # the three GEMMs: forward, dx, dW, at their operand layouts
    xc, xs, _ = HQ.hadamard_quest_quantize(x)
    wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
    q = {k: SR.sr_hadamard_quantize(v, signs[k], 7, 0.75, i)
         for i, (k, v) in enumerate(opnds.items(), 1)}
    args = [(xc, xs, wc.t(), ws.t()),
            (*q["dy"], q["Wq"][0].t(), q["Wq"][1].t()),
            (*q["xqᵀ"], q["dyᵀ"][0].t(), q["dyᵀ"][1].t())]
    deq = [(_deq(torch, a, sa).to(torch.bfloat16), _deq(torch, b.t(), sb.t()).to(torch.bfloat16).t())
           for a, sa, b, sb in args]
    nbytes = sum(a.numel() + sa.numel() * 4 + b.numel() + sb.numel() * 4
                 + a.shape[0] * b.shape[1] * 4 for a, sa, b, sb in args)
    nops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, _, b, _ in args)
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS
    rec[("mxfp4_matmul", "train")] = dict(
        ms=timer(lambda: [MM.mxfp4_matmul(*a) for a in args]),
        plain_ms=timer(lambda: [MM.mxfp4_matmul_plain(*a) for a in args]),
        bound_ms=max(by_bytes, by_ops) * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=timer(lambda: [torch.matmul(a, b) for a, b in deq]),
        launches_per_linear=3)
    return rec


# ---------------------------------------------------------------------------


SOURCES = {
    "hadamard_quest_quantize": ("src/repro_torch/csrc/hadamard_quant.cu",
                                "src/repro/kernels/hadamard_quant.py:73"),
    "sr_hadamard_quantize": ("src/repro_torch/csrc/sr_hadamard_quant.cu",
                             "src/repro/kernels/sr_hadamard_quant.py:69"),
    "mxfp4_matmul": ("src/repro_torch/csrc/mxfp4_matmul.cu",
                     "src/repro/kernels/mxfp4_matmul.py:61"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:238"),
    "kv_quant_pack": ("src/repro_torch/csrc/kv_pack.cu", "src/repro/kernels/kv_pack.py:101"),
    "kv_dequant_unpack": ("src/repro_torch/csrc/kv_pack.cu",
                          "src/repro/kernels/kv_pack.py:140"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
}
# each kernel's own path (launch counts) and the timing record of its line
PATH_OF = {"hadamard_quest_quantize": ("train", "train"),
           "sr_hadamard_quantize": ("train", "train"), "mxfp4_matmul": ("train", "train"),
           "paged_attention": ("engine", "decode"), "kv_quant_pack": ("engine", "decode"),
           "kv_dequant_unpack": ("gather", "gather"), "flash_attention": ("eval", "eval")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,engine,train,times",
                    help="comma-separated subset of kernels,engine,train,times")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    # plain f32 products in full f32 (no TF32), for the plain versions and
    # every reference product below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():  # -Xptxas -v: each entry, its registers and spills
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # B4b's body (a CTA per page, 16-byte stores): no stack, no spills
    deq = entry_resources(reports.get("kv_pack", ""), "kv_dequant")
    log(f"[build] kv_dequant bodies (registers, stack and spill bytes): "
        f"{json.dumps(deq) if deq else 'not built in this run'}")
    if "kernels" in phases and any(r.get("stack", 0) or r.get("spill_stores", 0)
                                   or r.get("spill_loads", 0) for r in deq.values()):
        raise AssertionError(f"kv_dequant bodies use a stack or spill: {deq}")
    # B2's vector bodies hold one 32-group a thread in straight-line code:
    # their static SASS count over 32 reads the instructions an element
    sass = sass_counts(str(_build.library_path("sr_hadamard_quant")), "sr_hadamard_")
    log(f"[build] sr_hadamard_quant SASS instructions by entry (per element = n / 32): "
        f"{json.dumps(sass) if sass else 'not measured (no cuobjdump)'}")

    cfg = get_config("qwen3-1.7b")
    tcfg = get_config(TRAIN_ARCH)
    err, counts, rec, vectors = {}, {}, {}, {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        err = check_kernels(torch, cfg)
        err.update(check_kv_and_flash(torch, cfg, tcfg))
        for name, e in check_training_kernels(torch, tcfg).items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[kernels] all kernels agree with their plain versions "
            f"(max |Δ| {err}) in {time.perf_counter() - t0:.1f} s")
    if "engine" in phases:
        t0 = time.perf_counter()
        summary, counts["engine"], gsummary, counts["gather"] = serve_full_width(torch, ops)
        vectors["engine"] = summary["vector_launches"]
        vectors["gather"] = gsummary["vector_launches"]
        log(f"[engine] launches on the main path (paged backend): {counts['engine']}")
        log(f"[engine] launches on the gather backend: {counts['gather']}")
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "paged_attention",
                               "kv_quant_pack") if counts["engine"][k] == 0]
        missing += [f"{k} (gather)" for k in ("kv_quant_pack", "kv_dequant_unpack")
                    if counts["gather"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the serving paths: {missing}")
        log(f"[engine] {json.dumps(summary)}")
        log(f"[engine] gather {json.dumps(gsummary)}")
        check_reduced_engine(torch)
        log(f"[engine] done in {time.perf_counter() - t0:.1f} s")
    if "train" in phases:
        t0 = time.perf_counter()
        train_reduced_card_vs_cpu(torch)
        summary, counts["train"], counts["eval"] = train_full_width(torch, ops)
        vectors["train"] = summary["vector_launches"]
        vectors["eval"] = summary["eval"]["vector_launches_flash"]
        log(f"[train] launches on the training path: {counts['train']} "
            f"(predicted {summary['predicted_launches']})")
        log(f"[train] launches on the flash evaluation path: {counts['eval']}")
        missing = [k for k in ("hadamard_quest_quantize", "sr_hadamard_quantize",
                               "mxfp4_matmul") if counts["train"][k] == 0]
        if missing or counts["eval"]["flash_attention"] == 0:
            raise AssertionError(f"kernels never launched on the training path: {missing} "
                                 f"or flash_attention on the evaluation path")
        if counts["train"]["flash_attention"]:
            raise AssertionError("flash_attention launched during training")
        log(f"[train] {json.dumps(summary)}")
        log(f"[train] done in {time.perf_counter() - t0:.1f} s")
    if vectors:
        # every B1 call on the main paths, and every B2 call on the training
        # path, reads and writes through the vector body (a thread per group,
        # 16-byte loads and stores)
        for tag, name, paths in (("b1", "hadamard_quest_quantize", list(vectors)),
                                 ("b2", "sr_hadamard_quantize", ["train"] if "train" in vectors
                                  else [])):
            vs = {p: (vectors[p][name], counts[p][name]) for p in paths}
            log(f"[{tag}] vector-body launches / all launches, by path: {json.dumps(vs)}")
            if any(v != n or n == 0 for v, n in vs.values()):
                raise AssertionError(f"{name} took its tile body on a main path: {vs}")
    if "times" in phases:
        t0 = time.perf_counter()
        timer = Timer(torch)
        rec = time_kernels(torch, cfg, timer)
        rec.update(time_training_kernels(torch, tcfg, timer))
        rec.update(time_kv_and_flash(torch, cfg, tcfg, timer))
        where = {"train": "one full-width linear", "gather": "one decode tick, all layers"}
        for (name, tag), r in rec.items():
            log(f"[times] {name} {tag} ({where.get(tag, 'one layer')}): {json.dumps(r)}")
        log(f"[times] done in {time.perf_counter() - t0:.1f} s")

    if phases >= {"kernels", "engine", "train", "times"}:
        # B5 and B4a at a decode tick, B4b at a decode tick's gather, B6 at
        # the evaluation shape, the training kernels at a training
        # microbatch; launches on each kernel's own path
        kernels = []
        for name, (src, replaces) in SOURCES.items():
            path, tag = PATH_OF[name]
            r = rec[(name, tag)]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": counts[path][name],
                            "max_abs_err": err[name], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                            "launches_by_path": {p: c[name] for p, c in counts.items()}})
            if name in ("hadamard_quest_quantize", "sr_hadamard_quantize"):
                kernels[-1]["vector_launches_by_path"] = {p: v[name] for p, v in vectors.items()}
        log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
