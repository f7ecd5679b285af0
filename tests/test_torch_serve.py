"""PyTorch port vs the JAX reference: the serving slice as a whole.

The port's ``prefill_all`` and ``decode_all`` (Quartet linears through the
kernel wrappers, which run their plain versions here) and the reference's
``build_paged_steps`` start from the same weights and an empty MXFP4 pool,
take the same ragged prompts in two prefill chunks and then two decode
steps, and must leave bit-identical pools behind every call with logits
within 1e-5 (f32 model; summation order is all that differs on this seed).

The gather backend (the reference's parity oracle) is held the same way:
per-slot ``prefill_chunk`` calls ([1, C] chunks, then [1, 1] remainders) and
``decode_all`` over the gathered dense view leave bit-identical pools with
logits within 1e-5; ``scatter_tokens`` / ``gather_pages`` leave the same
pool bytes and give the same dense views as the reference's.

The engine's greedy tokens are checked against the argmax of its own
teacher-forced forward under ``method="bf16"`` with a dense pool, not
against ``greedy_generate`` (ROADMAP C1); the gather and paged engines give
equal tokens there.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import paged_cache as JP
from repro.serve.paged_cache import PagedCache as JPagedCache
from repro.serve.steps import build_paged_steps as jbuild_steps
from repro.train import serve as JS
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, PagedCache
from repro_torch.serve import paged_cache as TP
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.steps import build_paged_steps
from repro_torch.train import serve as TS

PS, C, B, NPP = 8, 8, 3, 4


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_paged_steps_match_reference(method):
    jcfg = jget_reduced("qwen3-1.7b", dtype="float32")
    tcfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    jsteps = jbuild_steps(jm, method=method, page_size=PS, n_layers=jcfg.num_layers)
    tsteps = build_paged_steps(tm, method=method, page_size=PS)
    jpool = JPagedCache(jm, n_slots=B, pages_per_slot=NPP, page_size=PS,
                        n_pages=1 + B * NPP, kv_dtype="mxfp4").pool
    tpool = PagedCache(tcfg, n_slots=B, pages_per_slot=NPP, page_size=PS,
                       n_pages=1 + B * NPP, kv_dtype="mxfp4", device="cpu").pool
    tables = np.zeros((B, NPP), np.int32)
    tables[:, :3] = np.arange(1, 1 + 3 * B).reshape(B, 3)
    rng = np.random.default_rng(1)
    plen = [13, 5, 9]  # ragged: a full chunk + tail, one short chunk, a 1-token tail
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in plen]

    def check(jl, tl, rows):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], rtol=0, atol=1e-5)
        for name in jpool:
            np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))

    pos = [0] * B
    for _ in range(2):
        toks = np.zeros((B, C), np.int32)
        st, nv, mask = np.zeros(B, np.int32), np.zeros(B, np.int32), np.zeros(B, bool)
        for b in range(B):
            n = min(C, plen[b] - pos[b])
            if n > 0:
                toks[b, :n] = prompts[b][pos[b]:pos[b] + n]
                st[b], nv[b], mask[b] = pos[b], n, True
                pos[b] += n
        jl, jpool = jsteps.prefill_all(jp, *map(jnp.asarray, (toks, st, nv)), jpool,
                                       jnp.asarray(tables), jnp.asarray(mask))
        tl = tsteps.prefill_all(tp, *map(torch.from_numpy, (toks, st, nv)), tpool,
                                torch.from_numpy(tables), torch.from_numpy(mask))
        check(jl, tl, mask)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for i in range(2):
        posn, mask = np.asarray(plen, np.int32) + i, np.array([True, False, True])
        jl, jpool = jsteps.decode_all(jp, jnp.asarray(tok), jnp.asarray(posn), jpool,
                                      jnp.asarray(tables), jnp.asarray(mask))
        tl = tsteps.decode_all(tp, torch.from_numpy(tok), torch.from_numpy(posn), tpool,
                               torch.from_numpy(tables), torch.from_numpy(mask))
        check(jl, tl, mask)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_gather_steps_match_reference(method):
    """Under ``bf16`` the prompts have ragged tails, so [1, 1] remainder
    calls run too.  Under ``quartet`` they are whole chunks: the reference's
    forward of a single row differs from its own forward of the same row in
    a two-row batch (by 0.88 in the logits on this model; ROADMAP C1), while
    the port's does not, so a [1, 1] call has no reference oracle there."""
    jcfg = jget_reduced("qwen3-1.7b", dtype="float32")
    tcfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    jsteps = jbuild_steps(jm, method=method, page_size=PS, n_layers=jcfg.num_layers,
                          decode_backend="gather")
    tsteps = build_paged_steps(tm, method=method, page_size=PS, decode_backend="gather")
    assert tsteps.prefill_all is None
    jpool = JPagedCache(jm, n_slots=B, pages_per_slot=NPP, page_size=PS,
                        n_pages=1 + B * NPP, kv_dtype="mxfp4").pool
    tpool = PagedCache(tcfg, n_slots=B, pages_per_slot=NPP, page_size=PS,
                       n_pages=1 + B * NPP, kv_dtype="mxfp4", device="cpu").pool
    tables = np.zeros((B, NPP), np.int32)
    tables[:, :3] = np.arange(1, 1 + 3 * B).reshape(B, 3)
    rng = np.random.default_rng(1)
    plen = [13, 5, 9] if method == "bf16" else [16, 8, 8]
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in plen]

    def check(jl, tl, rows):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], rtol=0, atol=1e-5)
        for name in jpool:
            np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))

    tok = np.zeros((B, 1), np.int32)
    for b, p in enumerate(prompts):  # the engine's per-slot schedule
        pos, sizes = 0, [C] * (len(p) // C) + [1] * (len(p) % C)
        for n in sizes:
            toks = p[None, pos:pos + n]
            jl, jpool = jsteps.prefill_chunk(jp, jnp.asarray(toks), jnp.int32(pos),
                                             jnp.asarray(tables[b]), jpool)
            tl = tsteps.prefill_chunk(tp, torch.from_numpy(toks), pos,
                                      torch.from_numpy(tables[b]), tpool)
            check(jl, tl, [0])
            pos += n
        tok[b, 0] = np.asarray(jl)[0].argmax()
    for i in range(2):
        posn, mask = np.asarray(plen, np.int32) + i, np.array([True, False, True])
        jl, jpool = jsteps.decode_all(jp, jnp.asarray(tok), jnp.asarray(posn), jpool,
                                      jnp.asarray(tables), jnp.asarray(mask))
        tl = tsteps.decode_all(tp, torch.from_numpy(tok), torch.from_numpy(posn), tpool,
                               torch.from_numpy(tables), torch.from_numpy(mask))
        check(jl, tl, mask)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_dense_cache_prefill_and_decode_match_reference(method):
    """``make_prefill_step`` then two ``make_decode_step`` calls over dense
    caches written at ``cache_index`` (two rows: ROADMAP C1's single-row
    case aside): logits and caches within 1e-5 (f32 model)."""
    jcfg = jget_reduced("qwen3-1.7b", dtype="float32")
    tcfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    jc, tc = JS.init_cache(jm, 2, 16), TS.init_cache(tm, 2, 16, "cpu")
    jl, jc, jpos = JS.make_prefill_step(jm, method=method)(jp, jnp.asarray(tokens), jc)
    tl, tc, tpos = TS.make_prefill_step(tm, method=method)(tp, torch.from_numpy(tokens), tc)
    jdec, tdec = JS.make_decode_step(jm, method=method), TS.make_decode_step(tm, method=method)
    for _ in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc, jpos = jdec(jp, jnp.asarray(tok), jpos, jc)
        tl, tc, tpos = tdec(tp, torch.from_numpy(tok), tpos, tc)


@pytest.mark.parametrize("kv", ["mxfp4", "dense"])
def test_scatter_tokens_and_gather_pages_match_reference(kv):
    L, n_pages, ps, H, hd, N = 2, 7, 4, 2, 64, 5
    rng = np.random.default_rng(6)
    if kv == "dense":
        jpool = {n: jnp.zeros((L, n_pages, ps, H, hd), jnp.float32) for n in ("k", "v")}
    else:
        jpool = {n: jnp.zeros((L, n_pages, ps, H, w), jnp.uint8) for n, w in
                 (("k_codes", hd // 2), ("k_scales", 2), ("v_codes", hd // 2), ("v_scales", 2))}
    tpool = {n: torch.from_numpy(np.asarray(a).copy()) for n, a in jpool.items()}
    pid = np.array([2, 5, 1, 2, 6], np.int32)
    off = np.array([0, 3, 1, 3, 2], np.int32)
    k, v = ((rng.standard_normal((L, N, H, hd)) * 2).astype(np.float32) for _ in range(2))
    jpool = JP.scatter_tokens(jpool, jnp.asarray(pid), jnp.asarray(off), jnp.asarray(k),
                              jnp.asarray(v))
    TP.scatter_tokens(tpool, torch.from_numpy(pid), torch.from_numpy(off),
                      torch.from_numpy(k), torch.from_numpy(v))
    for name in jpool:
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    tables = np.array([[2, 5], [1, 6], [0, 0]], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JP.gather_pages(jpool, jnp.asarray(tables), jdt)
        got = TP.gather_pages(tpool, torch.from_numpy(tables), tdt)
        for g, w in zip(got, want):
            assert g.shape == (L, 3, 2 * ps, H, hd)
            assert g.dtype == (tdt if kv == "mxfp4" else torch.float32)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    if kv == "mxfp4":
        pq = TP.quantize_kv(torch.from_numpy(k))
        jq = JP.quantize_kv(jnp.asarray(k))
        np.testing.assert_array_equal(pq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(
            TP.dequantize_kv(pq.codes, pq.scales, torch.float32).numpy(),
            np.asarray(JP.dequantize_kv(jq.codes, jq.scales, jnp.float32)))


@pytest.fixture(scope="module")
def small_model():
    cfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    return build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("chunk", [4, 8])
def test_engine_tokens_equal_teacher_forced_argmax(small_model, chunk):
    model, params = small_model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 3, 9)]
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=24, page_size=4,
                                             kv_dtype="dense", prefill_chunk=chunk,
                                             method="bf16"))
    reqs = [eng.submit(p, 5) for p in prompts]
    assert eng.drain() and all(r.done and len(r.tokens) == 5 for r in reqs)
    for p, r in zip(prompts, reqs):
        seq = torch.from_numpy(np.concatenate([p, r.tokens[:-1]]).astype(np.int32))[None]
        tf, _ = model.forward(params, seq, 0, method="bf16")
        assert r.tokens == tf[0, p.size - 1:].argmax(-1).tolist()
    eng.cache.check_invariants()
    assert eng.cache.free_pages == eng.cache.n_pages - 1  # every page came back


@pytest.mark.parametrize("chunk", [4, 8])
def test_engine_gather_tokens_equal_paged(small_model, chunk):
    """The reduced engine on both backends under ``method="bf16"`` with a
    dense pool: equal tokens, and the gather engine's follow the per-slot
    prefill schedule ([1, C] chunks, then [1, 1] remainders)."""
    model, params = small_model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 3, 9)]
    tokens = {}
    for backend in ("paged", "gather"):
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=24, page_size=4,
                                                 kv_dtype="dense", prefill_chunk=chunk,
                                                 method="bf16", decode_backend=backend))
        assert eng.decode_backend == backend
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.drain()
        tokens[backend] = [r.tokens for r in reqs]
        eng.cache.check_invariants()
    assert tokens["gather"] == tokens["paged"]
    flash_model = build_model(model.cfg, attn_backend="flash")
    assert Engine(flash_model, params, EngineConfig(max_len=24)).decode_backend == "gather"


def test_engine_stops_at_eos(small_model):
    model, params = small_model
    prompt = np.random.default_rng(4).integers(0, model.cfg.vocab_size, 6).astype(np.int32)

    def run(eos):
        eng = Engine(model, params, EngineConfig(n_slots=1, max_len=16, page_size=4,
                                                 prefill_chunk=4, eos_id=eos))
        req = eng.submit(prompt, 5)
        eng.drain()
        return req

    full = run(None)
    assert full.finish_reason == "max_tokens" and len(full.tokens) == 5
    cut = run(full.tokens[1])
    k = full.tokens.index(full.tokens[1])
    assert cut.finish_reason == "eos" and cut.tokens == full.tokens[:k + 1]


def test_engine_mxfp4_quartet_close_to_teacher_forced(small_model):
    """The main path's numerics (MXFP4 pool, Quartet linears): first-token
    log-probs within the reference test's bound of the unquantized-KV
    teacher-forced forward (tests/test_paged_attention.py)."""
    model, params = small_model
    prompt = np.random.default_rng(3).integers(0, model.cfg.vocab_size, 11).astype(np.int32)
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                             prefill_chunk=8, keep_logits=True))
    req = eng.submit(prompt, 4)
    eng.drain()
    tf, _ = model.forward(params, torch.from_numpy(prompt)[None], 0)
    d = np.abs(torch.log_softmax(tf[0, -1], -1).numpy()
               - torch.log_softmax(torch.from_numpy(req.logits_trace[0]), -1).numpy())
    assert d.max() < 2.5 and d.mean() < 0.5
    assert eng.cache_bytes() == 2 * 2 * (1 + 2 * 4) * 8 * 2 * (16 + 1)  # 4.25 bits/element


def test_scheduler_fifo_admission_and_page_reservation():
    cfg = get_reduced_config("qwen3-1.7b")
    cache = PagedCache(cfg, n_slots=2, pages_per_slot=3, page_size=4, n_pages=5,
                       kv_dtype="dense", device="cpu")
    sched = Scheduler(n_slots=2, max_len=12, prefill_chunk=4)
    a = sched.submit(np.arange(9), 3)  # 12 tokens → 3 pages
    b = sched.submit(np.arange(2), 2)  # 4 tokens → 1 page: fits, but waits its turn
    c = sched.submit(np.arange(5), 1)
    can = lambda r: cache.can_alloc(r.prompt_len + r.max_new)
    alloc = lambda r: cache.alloc(r.slot, r.prompt_len + r.max_new)
    assert sched.admit(can, alloc) == [a, b]
    assert cache.tables.tolist() == [[1, 2, 3], [4, 0, 0]]
    assert sched.prefill_batch() == [(a, 0, 4), (b, 0, 2)]
    assert sched.admit(can, alloc) == []  # no slot free
    sched.retire(a, "max_tokens", 0.0)
    cache.free(a.slot)
    assert sched.admit(can, alloc) == [c] and cache.tables[c.slot].tolist() == [1, 2, 0]
    cache.check_invariants()
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(np.arange(11), 2)


def test_launcher_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve_engine

    monkeypatch.setattr(sys, "argv", ["serve_engine", "--reduced", "--device", "cpu",
                                      "--requests", "3", "--max-new", "3"])
    serve_engine.main()
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out


def test_launcher_gather_backend_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve_engine

    monkeypatch.setattr(sys, "argv", ["serve_engine", "--reduced", "--device", "cpu",
                                      "--requests", "2", "--max-new", "3",
                                      "--decode-backend", "gather"])
    serve_engine.main()
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "decode=gather" in out


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or any module of the reference package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert len(mods) >= 20 and not bad, (len(mods), bad)\n"
        "print('ok', len(mods))\n")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    # chip_smoke.py is held to the same rule, and refuses to run without a card
    with open(os.path.join(root, "chip_smoke.py")) as f:
        text = f.read()
    assert "import jax" not in text and "from repro." not in text and "import repro\n" not in text
