"""PyTorch port vs the JAX reference: serving the MoE family.

The port's paged steps (``prefill_all`` over ragged chunks, ``decode_all``
with a masked lane) on reduced qwen3-moe-235b-a22b, from the reference's
weights and an empty MXFP4 pool, against the reference's
``build_paged_steps``: bit-identical pools after every call and logits
within 1e-5 (f32 model; the expert GEMMs sum in another order).  Both sides
build ``token_valid`` from the slot mask and each row's ``n_valid``, so
padding lanes never compete for expert capacity.

The engine on reduced MoE (the port's own weights, Quartet linears through
the kernels' plain versions): under ``method="bf16"`` with a dense pool its
greedy tokens equal the argmax of its own teacher-forced forward on both
backends (so paged = gather); under Quartet with the MXFP4 pool its
first-token log-probs stay within the reference test's 2.5 / 0.5 of the
teacher-forced forward; self-speculation is token-exact (the twin of the
reference's ``test_moe_self_spec_token_exact``); the prefix cache's warm
run equals the cold one.  Reduced arctic (dense residual) runs the two
engine-against-teacher-forced checks too.
"""

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
from repro_torch.serve import Engine, EngineConfig, PagedCache, SpecConfig
from repro_torch.serve.steps import build_paged_steps

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
PS, C, B, NPP = 8, 8, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_moe_paged_steps_match_reference(method):
    jcfg = jget_reduced("qwen3-moe-235b-a22b", dtype="float32")
    tcfg = kernel_config(get_reduced_config("qwen3-moe-235b-a22b", dtype="float32"))
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


def _model(arch):
    cfg = kernel_config(get_reduced_config(arch, dtype="float32"))
    return build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def qwen_moe():
    return _model(ARCHS[0])


PROMPT_LENS = (7, 12, 3, 9)


def _prompts(vocab, lens=PROMPT_LENS, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def test_moe_engine_bf16_tokens_teacher_forced_and_backends_equal(moe_model):
    """Both backends, bf16, dense pool: greedy tokens equal the argmax of the
    teacher-forced forward, so the paged and gather engines agree."""
    model, params = moe_model
    prompts = _prompts(model.cfg.vocab_size)
    tokens = {}
    for backend in ("paged", "gather"):
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=24, page_size=4,
                                                 kv_dtype="dense", prefill_chunk=4,
                                                 method="bf16", decode_backend=backend))
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.drain()
        tokens[backend] = [r.tokens for r in reqs]
        eng.cache.check_invariants()
        assert eng.cache.free_pages == eng.cache.n_pages - 1
    assert tokens["gather"] == tokens["paged"]
    for p, toks in zip(prompts, tokens["paged"]):
        seq = torch.from_numpy(np.concatenate([p, toks[:-1]]).astype(np.int32))[None]
        tf, _ = model.forward(params, seq, 0, method="bf16")
        assert toks == tf[0, p.size - 1:].argmax(-1).tolist()


@pytest.mark.parametrize("backend", ["paged", "gather"])
def test_moe_engine_mxfp4_quartet_close_to_teacher_forced(moe_model, backend):
    """The main path's numerics (MXFP4 pool, Quartet linears, expert-axis
    kernels' plain versions): first-token log-probs within the reference
    test's bound of the unquantized-KV teacher-forced forward
    (tests/test_paged_attention.py)."""
    model, params = moe_model
    prompt = _prompts(model.cfg.vocab_size, (11,), seed=3)[0]
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                             prefill_chunk=8, keep_logits=True,
                                             decode_backend=backend))
    req = eng.submit(prompt, 4)
    eng.drain()
    tf, _ = model.forward(params, torch.from_numpy(prompt)[None], 0)
    d = np.abs(torch.log_softmax(tf[0, -1], -1).numpy()
               - torch.log_softmax(torch.from_numpy(req.logits_trace[0]), -1).numpy())
    assert d.max() < 2.5 and d.mean() < 0.5


def _run(model, params, prompts, max_new=4, *, spec=None, kv="dense", prefix=False,
         waves=None):
    eng = Engine(model, params, EngineConfig(n_slots=3, max_len=48, page_size=8, kv_dtype=kv,
                                             prefill_chunk=8, spec=spec, prefix_cache=prefix,
                                             debug_cache=True))
    out = []
    for wave in waves or [prompts]:
        handles = [eng.submit(p, max_new) for p in wave]
        eng.drain()
        out += handles
    return eng, out


@pytest.mark.parametrize("kv", ["dense", "mxfp4"])
def test_moe_self_spec_token_exact(qwen_moe, kv):
    """Twin of the reference's ``test_moe_self_spec_token_exact``: per-token
    top-k routing over multi-token verify bursts at per-slot offsets stays
    exact; self-speculation accepts every draft."""
    model, params = qwen_moe
    prompts = _prompts(model.cfg.vocab_size, (6, 9), seed=3)
    _, base = _run(model, params, prompts, kv=kv)
    eng, spec = _run(model, params, prompts, kv=kv, spec=SpecConfig(k=2, proposer="self"))
    for b, s in zip(base, spec):
        assert s.tokens == b.tokens
        assert s.acceptance_rate() == 1.0
    eng.cache.check_invariants()


def test_moe_prefix_cache_warm_equals_cold(qwen_moe):
    """A shared two-page prefix: the warm run (prefix hits, a copy-on-write of
    the pure-prefix prompt's last page) emits the cold run's tokens."""
    model, params = qwen_moe
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, model.cfg.vocab_size, 16).astype(np.int32)
    tails = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32) for n in (3, 5)]
    waves = [[np.concatenate([prefix, tails[0]])],
             [prefix.copy(), np.concatenate([prefix, tails[1]])]]
    for kv in ("dense", "mxfp4"):
        warm_eng, warm = _run(model, params, None, kv=kv, prefix=True, waves=waves)
        _, cold = _run(model, params, None, kv=kv, waves=waves)
        assert [h.tokens for h in warm] == [h.tokens for h in cold]
        counter = warm_eng.telemetry.registry.counter
        assert counter("prefix_hit_requests").value == 2
        assert counter("prefix_cow_pages").value == 1
        warm_eng.cache.check_invariants()


def test_moe_draft_proposer_refuses_a_moe_draft(qwen_moe):
    """The draft proposer stays dense-only, as in the reference."""
    model, params = qwen_moe
    spec = SpecConfig(k=2, proposer="draft", draft_arch=model.cfg.name.removesuffix("-reduced"))
    with pytest.raises(ValueError, match="dense"):
        Engine(model, params, EngineConfig(n_slots=2, max_len=24, page_size=4,
                                           prefill_chunk=4, spec=spec))
    # speculation with the n-gram proposer serves MoE too, token-exact
    prompts = _prompts(model.cfg.vocab_size, (6, 9), seed=3)
    _, base = _run(model, params, prompts)
    _, ngram = _run(model, params, prompts, spec=SpecConfig(k=2, proposer="ngram"))
    assert [h.tokens for h in ngram] == [h.tokens for h in base]
