"""PyTorch port vs the JAX reference: the serving slice as a whole.

The port's ``prefill_all`` and ``decode_all`` (Quartet linears through the
kernel wrappers, which run their plain versions here) and the reference's
``build_paged_steps`` start from the same weights and an empty MXFP4 pool,
take the same ragged prompts in two prefill chunks and then two decode
steps, and must leave bit-identical pools behind every call with logits
within 1e-5 (f32 model; summation order is all that differs on this seed).

The engine's greedy tokens are checked against the argmax of its own
teacher-forced forward under ``method="bf16"`` with a dense pool, not
against ``greedy_generate`` (ROADMAP C1).
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
from repro.serve.paged_cache import PagedCache as JPagedCache
from repro.serve.steps import build_paged_steps as jbuild_steps
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, PagedCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.steps import build_paged_steps

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
