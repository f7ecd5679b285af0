"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds every kernel of the
   serving and training paths from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together).
2. Checks each kernel against its plain PyTorch version on the card at the
   full-width qwen3-1.7b shapes of the serving path and the full-width
   llama-paper-200m shapes of a training step (16 x 512 tokens), and one
   full-width ``quartet_linear`` backward on the kernels against the same
   backward on the plain versions (a mismatch raises).
3. Serves 8 requests with the port's ``Engine`` on full-width, full-depth
   qwen3-1.7b (random weights from a seed, MXFP4 KV pool, paged attention,
   greedy decoding, Quartet linears through the kernels), with every launch
   counter set to 0 just before and read just after; then holds a reduced
   model's engine tokens against its own teacher-forced forward.
4. Trains: a reduced Llama 3 steps on the card (kernels) and on the CPU
   (plain versions), losses and grad-norms compared; then full-width,
   full-depth llama-paper-200m 5 steps through ``train.loop.train`` (batch
   32 x 512, 2 microbatches, Quartet on every transformer linear), with every
   launch counter set to 0 just before and read just after, beside the
   predicted counts; prints tokens/s, the median step time and peak memory.
5. Times each kernel (CUDA events, median, L2 flushed before each launch)
   beside its plain version and, where one PyTorch call computes the same
   function, that call, at serving and training shapes; prints the engine's
   tok/s and TTFT.
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

# serving traffic of the engine phase
N_SLOTS, PAGE_SIZE, MAX_LEN, PREFILL_CHUNK = 8, 16, 640, 64
N_REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 8, 128, 512, 32
SEED = 0

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
    err["paged_attention"] = worst
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------


def serve_full_width(torch, ops, device="cuda"):
    """8 requests on full-width, full-depth qwen3-1.7b through the engine.
    Returns (summary dict, launch counts of that run)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig

    cfg = kernel_config(get_config("qwen3-1.7b"))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    log(f"  init: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
        f"in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]

    def run(keep_logits: bool):
        eng = Engine(model, params, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE, kv_dtype="mxfp4",
            prefill_chunk=PREFILL_CHUNK, keep_logits=keep_logits))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, MAX_NEW, arrival_time=0.0) for p in prompts]
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
        return eng, reqs, time.perf_counter() - t0, first, ticks

    run(False)  # warm-up: first-use costs (allocator, library handles)
    ops.reset_launch_counts()
    eng, reqs, wall, _, _ = run(True)
    counts = ops.launch_counts()
    for r in reqs:
        if len(r.tokens) != MAX_NEW or r.finish_reason != "max_tokens":
            raise AssertionError(f"request {r.rid} finished with {len(r.tokens)} tokens "
                                 f"({r.finish_reason!r})")
        for row in r.logits_trace:
            if row.shape != (cfg.vocab_size,) or not np.isfinite(row).all():
                raise AssertionError(f"request {r.rid}: non-finite or misshapen logits")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    log(f"  main-path run: {len(reqs)} requests x {MAX_NEW} tokens, prompts "
        f"{[int(p.size) for p in prompts]}, {eng.steps} steps, {wall:.3f} s "
        f"(logits copied to the host for the checks)")
    _, reqs, wall, first, ticks = run(False)
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"requests": len(reqs), "tokens": toks, "wall_s": wall,
               "tok_per_s": toks / wall, "ttft_mean_s": float(np.mean(ttft)),
               "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "kv_pool_bytes": eng.cache_bytes(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    torch.cuda.empty_cache()
    return summary, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_reduced_engine(torch, device="cuda"):
    """The repo's token oracle at a small size on the card: under the bf16
    method with a dense pool the engine's greedy tokens equal the argmax of
    its own teacher-forced forward (f32 model); with the MXFP4 pool and the
    Quartet kernels its first-token log-probs stay within the reference
    test's bound of the teacher-forced ones."""
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
    for kv, method in (("dense", "bf16"), ("mxfp4", "quartet")):
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48, page_size=8,
                                                 kv_dtype=kv, prefill_chunk=8,
                                                 method=method, keep_logits=True))
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
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
    log("  reduced engine: dense/bf16 tokens == teacher-forced argmax; "
        "mxfp4/quartet first-token log-probs within bound")


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

        nbytes = sum(x.numel() * (2 + 2) + x.numel() // 32 * 4 for x in xs + ws)
        rec[("hadamard_quest_quantize", tag)] = dict(
            ms=timer(hq(HQ.hadamard_quest_quantize)),
            plain_ms=timer(hq(HQ.hadamard_quest_quantize_plain)),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
            launches_per_layer=2 * len(xs))

        args = [(a[0], a[1], w[0].t(), w[1].t()) for a, w in zip(qa, qw)]
        deq = [(_deq(torch, a[0], a[1]).to(torch.bfloat16),
                _deq(torch, w[0], w[1]).to(torch.bfloat16).t()) for a, w in zip(qa, qw)]
        nbytes = sum(a.numel() * 1 + s.numel() * 4 + b.numel() + t.numel() * 4
                     + a.shape[0] * b.shape[1] * 4 for a, s, b, t in args)
        nops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, _, b, _ in args)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS) * 1e3
        rec[("mxfp4_matmul", tag)] = dict(
            ms=timer(lambda: [MM.mxfp4_matmul(*a) for a in args]),
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
            plain_ms=timer(lambda: PA.paged_attention_plain(q, pool, tables, ln)),
            bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_BF16_OPS
            else "operations",
            library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(*lib)),
            launches_per_layer=1)
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
    dy [T, N] (bf16), the dequantized weight [K, N] (f32), and the two
    transposed views xqᵀ [K, T] (f32) and dyᵀ [N, T] (bf16)."""
    from repro_torch.core.quartet import _dequant_codes
    from repro_torch.kernels import hadamard_quant as HQ

    T = TRAIN_TOKENS_MB
    x = torch.randn((T, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
    dy = (torch.randn((T, N), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    xc, xs, _ = HQ.hadamard_quest_quantize(x)
    wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
    return {"dy": dy, "Wq": _dequant_codes(wc, ws, 32).t().contiguous(),
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
    # sr_hadamard_quantize: the up projection's four operands (K 1280, N
    # 3456), codes and scales bit-exact, transposed views included
    d, f = cfg.d_model, cfg.d_ff
    codes = {}
    for salt, (name, x) in enumerate(backward_operands(torch, d, f, gen, device).items(), 1):
        signs = fastrng.rademacher(seed, x.shape[1], salt=11 if salt < 3 else 12, device=device)
        got = SR.sr_hadamard_quantize(x, signs, seed, salt=salt)
        want = SR.sr_hadamard_quantize_plain(x, signs, seed, salt=salt)
        for g, w_, what in zip(got, want, ("codes", "scales")):
            if not torch.equal(g, w_):
                raise AssertionError(f"sr_hadamard_quantize {name} {tuple(x.shape)} "
                                     f"(strides {x.stride()}): {what} differ at "
                                     f"{int((g != w_).sum())} places")
        codes[name] = got
    err["sr_hadamard_quantize"] = 0.0

    # mxfp4_matmul at the backward's operand layouts: dx [T, N]·[N, K] and
    # dW [K, T]·[T, N] with B the transposed view of the SR codes, and the
    # down projection's dW (M = d_ff rows, 8192-token contraction)
    down = backward_operands(torch, f, d, gen, device)
    sb = fastrng.rademacher(seed, TRAIN_TOKENS_MB, salt=12, device=device)
    dc = SR.sr_hadamard_quantize(down["xqᵀ"], sb, seed, salt=3)
    dg = SR.sr_hadamard_quantize(down["dyᵀ"], sb, seed, salt=4)
    cases = {"dx": (*codes["dy"], codes["Wq"][0].t(), codes["Wq"][1].t()),
             "dW": (*codes["xqᵀ"], codes["dyᵀ"][0].t(), codes["dyᵀ"][1].t()),
             "dW down": (*dc, dg[0].t(), dg[1].t())}
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
               "launches": counts, "predicted_launches": predicted}
    summary["breakdown"] = profile_train_step(torch, model, opt, state, batcher, device)
    del state
    torch.cuda.empty_cache()
    return summary, counts


KERNEL_NAMES = {"hadamard_quest_kernel": "hadamard_quest_quantize",
                "sr_hadamard_kernel": "sr_hadamard_quantize",
                "mxfp4_matmul_kernel": "mxfp4_matmul", "paged_attention": "paged_attention"}


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
        plain_ms=timer(lambda: (HQ.hadamard_quest_quantize_plain(x),
                                HQ.hadamard_quest_quantize_plain(w.t()))),
        bound_ms=n * (2 + 1 + 1 + 4 / 32) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, launches_per_linear_fwd=2)

    # backward Stage 1: the four operands (each element read once at its
    # width, 2 B for dy and dyᵀ, 4 B for Wq and xqᵀ; written as a 1 B code
    # and 4/32 B of scale)
    opnds = backward_operands(torch, d, f, gen, device)
    signs = {k: fastrng.rademacher(7, v.shape[1], salt=11, device=device)
             for k, v in opnds.items()}
    nbytes = sum(v.numel() * (v.element_size() + 1 + 4 / 32) for v in opnds.values())

    def sr(fn):
        return lambda: [fn(v, signs[k], 7, 0.75, i) for i, (k, v) in enumerate(opnds.items(), 1)]

    rec[("sr_hadamard_quantize", "train")] = dict(
        ms=timer(sr(SR.sr_hadamard_quantize)), plain_ms=timer(sr(SR.sr_hadamard_quantize_plain)),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
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
}


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
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("qwen3-1.7b")
    tcfg = get_config(TRAIN_ARCH)
    err, counts, rec = {}, {}, {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        err = check_kernels(torch, cfg)
        for name, e in check_training_kernels(torch, tcfg).items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[kernels] all kernels agree with their plain versions "
            f"(max |Δ| {err}) in {time.perf_counter() - t0:.1f} s")
    if "engine" in phases:
        t0 = time.perf_counter()
        summary, counts["engine"] = serve_full_width(torch, ops)
        log(f"[engine] launches on the main path: {counts['engine']}")
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "paged_attention")
                   if counts["engine"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the serving path: {missing}")
        log(f"[engine] {json.dumps(summary)}")
        check_reduced_engine(torch)
        log(f"[engine] done in {time.perf_counter() - t0:.1f} s")
    if "train" in phases:
        t0 = time.perf_counter()
        train_reduced_card_vs_cpu(torch)
        summary, counts["train"] = train_full_width(torch, ops)
        log(f"[train] launches on the training path: {counts['train']} "
            f"(predicted {summary['predicted_launches']})")
        missing = [k for k in ("hadamard_quest_quantize", "sr_hadamard_quantize",
                               "mxfp4_matmul") if counts["train"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the training path: {missing}")
        log(f"[train] {json.dumps(summary)}")
        log(f"[train] done in {time.perf_counter() - t0:.1f} s")
    if "times" in phases:
        t0 = time.perf_counter()
        timer = Timer(torch)
        rec = time_kernels(torch, cfg, timer)
        rec.update(time_training_kernels(torch, tcfg, timer))
        for (name, tag), r in rec.items():
            where = "one full-width linear" if tag == "train" else "one layer"
            log(f"[times] {name} {tag} ({where}): {json.dumps(r)}")
        log(f"[times] done in {time.perf_counter() - t0:.1f} s")

    if phases >= {"kernels", "engine", "train", "times"}:
        # the serving kernel B5 at a decode tick, the training kernels at a
        # training microbatch; launches on each kernel's own path
        kernels = []
        for name, (src, replaces) in SOURCES.items():
            path = "engine" if name == "paged_attention" else "train"
            r = rec[(name, "decode" if path == "engine" else "train")]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": counts[path][name],
                            "max_abs_err": err[name], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                            "launches_by_path": {p: c[name] for p, c in counts.items()}})
        log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
