"""PyTorch port vs the JAX reference: speculative decoding (dense family).

Twins of ``tests/test_spec_decode.py``, held inside the port:

* Greedy speculation with any proposer emits exactly the tokens of the
  port's non-speculative engine, over ragged concurrent requests, on the
  dense pool (both backends) and the MXFP4 pool (paged backend; the
  reference excludes MXFP4 on the gather backend, whose verify attends over
  the drafted tokens' K/V before quantization).  Self-speculation accepts
  every draft.
* EOS inside a burst and the token budget stop emission; the acceptance
  accounting counts only drafts at emittable positions, and all k of a burst
  ended by a rejection.
* A pool sized exactly to its reservations decodes to the budget: a burst
  maps no page past the reservation.
* Logical lengths grow monotonically; ``truncate`` / ``ensure`` keep the
  free list sorted and reuse pages low-ids-first.
* Sampled self-speculation reproduces the sampled non-speculative stream.

Against the reference at host level: ``accept_tokens``,
``aggregate_stats``, the n-gram matcher, ``reservation_sizing`` and the
allocator's ``truncate`` / ``ensure`` schedules give the reference's
results.  MoE speculation waits for the MoE slice (ROADMAP A5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import PagedCache as JPagedCache
from repro.serve import paged_cache as JP
from repro.serve.spec import aggregate_stats as jaggregate_stats
from repro.serve.spec.proposers import NGramProposer as JNGramProposer
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.models.registry import Model
from repro_torch.serve import Engine, EngineConfig, PagedCache, SamplingParams, SpecConfig
from repro_torch.serve import paged_cache as P
from repro_torch.serve.spec import accept_tokens, aggregate_stats
from repro_torch.serve.spec.proposers import NGramProposer, Proposer, register_proposer
from repro_torch.train.serve import greedy_generate

pytestmark = pytest.mark.spec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen_setup():
    cfg = kernel_config(get_reduced_config("qwen3-1.7b"))
    return cfg, build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(cfg, lens=(7, 12, 5), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _run(model, params, prompts, max_new=6, *, spec=None, kv="dense", backend=None,
         sampling=None, n_slots=3, eos_id=None):
    eng = Engine(model, params, EngineConfig(
        n_slots=n_slots, max_len=32, page_size=8, kv_dtype=kv, prefill_chunk=8,
        decode_backend=backend, spec=spec, eos_id=eos_id, debug_cache=True))
    handles = [eng.submit(p, max_new, sampling=sampling) for p in prompts]
    eng.drain()
    return eng, handles


# ---------------------------------------------------------------------------
# host logic against the reference
# ---------------------------------------------------------------------------


def test_accept_tokens():
    assert accept_tokens([1, 2, 3], [1, 2, 3, 9]) == (3, [1, 2, 3, 9])  # bonus rides along
    assert accept_tokens([1, 2, 3], [1, 7, 8, 9]) == (1, [1, 7])  # correction, suffix dropped
    assert accept_tokens([1, 2, 3], [5, 6, 7, 8]) == (0, [5])
    with pytest.raises(ValueError):
        accept_tokens([1, 2], [1, 2])
    with pytest.raises(ValueError):
        SpecConfig(k=0)
    with pytest.raises(ValueError):
        SpecConfig(ngram=0)
    with pytest.raises(ValueError):
        SpecConfig(draft_kv_dtype="fp8")


def test_ngram_match_and_sizing_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        ctx = rng.integers(0, 6, int(rng.integers(1, 30))).astype(np.int32)
        n, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        assert np.array_equal(NGramProposer._match(ctx, n, k), JNGramProposer._match(ctx, n, k))
    for args in ((4, 128, 16, 0), (3, 32, 8, 3), (8, 640, 16, 4), (2, 16, 4, 7)):
        assert P.reservation_sizing(*args) == JP.reservation_sizing(*args)


def test_truncate_and_ensure_match_reference():
    """The allocator schedule of the reference's truncate / ensure tests on
    both packages: equal tables and free lists at every step."""
    jmodel = jbuild(jget_reduced("qwen3-1.7b"))
    cfg = get_reduced_config("qwen3-1.7b")
    logs = []
    for cache in (JPagedCache(jmodel, n_slots=2, pages_per_slot=4, page_size=4,
                              kv_dtype="dense"),
                  PagedCache(cfg, n_slots=2, pages_per_slot=4, page_size=4, kv_dtype="dense",
                             device="cpu")):
        log = []
        cache.alloc(0, 16)  # pages 1, 2, 3, 4
        log.append(cache.truncate(0, 9))  # 9 tokens keep 3 pages: page 4 freed
        log.append((cache.tables.tolist(), cache.mapped_pages(0), list(cache._free)))
        cache.alloc(1, 4)  # the freed page goes out first
        log.append(cache.ensure(0, 16))  # then the next lowest id
        log.append(cache.tables.tolist())
        log.append((cache.truncate(0, 12), cache.truncate(0, 12)))
        with pytest.raises(ValueError):
            cache.ensure(0, 17)
        log.append((cache.ensure(0, 8), cache.ensure(0, 12), cache.free_pages))
        cache.check_invariants()
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][:4] == [1, ([[1, 2, 3, 0], [0, 0, 0, 0]], 3, [8, 7, 6, 5, 4]), 1,
                           [[1, 2, 3, 5], [4, 0, 0, 0]]]


# ---------------------------------------------------------------------------
# greedy token-exactness: spec engine == non-spec engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv,backend", [("dense", "paged"), ("dense", "gather"),
                                        ("mxfp4", "paged")])
def test_self_spec_token_exact(qwen_setup, kv, backend):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg)
    _, base = _run(model, params, prompts, kv=kv, backend=backend)
    eng, spec_h = _run(model, params, prompts, kv=kv, backend=backend,
                       spec=SpecConfig(k=3, proposer="self"))
    for b, s in zip(base, spec_h):
        assert s.tokens == b.tokens
        assert s.acceptance_rate() == 1.0
        assert s.tokens_per_decode_call() > 1.0
    assert eng.telemetry.registry.gauge("spec_acceptance_rate").value == 1.0
    assert eng.cache.free_pages == eng.cache.n_pages - 1  # every page came back
    # the reference's fleet accounting reads the port's requests alike
    assert aggregate_stats(spec_h) == jaggregate_stats(spec_h)


def test_ngram_spec_token_exact_and_bounded_acceptance(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg)
    for kv in ("dense", "mxfp4"):
        _, base = _run(model, params, prompts, kv=kv)
        _, spec_h = _run(model, params, prompts, kv=kv,
                         spec=SpecConfig(k=3, proposer="ngram", ngram=2))
        for b, s in zip(base, spec_h):
            assert s.tokens == b.tokens
            assert 0.0 <= s.acceptance_rate() <= 1.0
            assert 1.0 <= s.tokens_per_decode_call() <= 4.0


@pytest.mark.parametrize("backend", ["paged", "gather"])
def test_draft_model_spec_token_exact(qwen_setup, backend):
    """The draft proposer with draft == target (same arch, config and seed):
    its mirror cache (lazy batched prefill sync, lock-step rollback) keeps
    the outputs exact and accepts every draft."""
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 12))
    spec = SpecConfig(k=3, proposer="draft", draft_arch="qwen3-1.7b", draft_kv_dtype="mxfp4")
    _, base = _run(model, params, prompts, kv="mxfp4")
    eng, spec_h = _run(model, params, prompts, kv="mxfp4", spec=spec)
    for b, s in zip(base, spec_h):
        assert s.tokens == b.tokens
        assert s.acceptance_rate() == 1.0
    assert eng.proposer.cache.free_pages == eng.proposer.cache.n_pages - 1
    # on the gather backend the target differs from its paged draft (another
    # attention), so only exactness and the accounting's range hold
    _, base = _run(model, params, prompts, kv="dense", backend=backend)
    _, spec_h = _run(model, params, prompts, kv="dense", backend=backend,
                     spec=dataclasses.replace(spec, draft_kv_dtype="dense"))
    for b, s in zip(base, spec_h):
        assert s.tokens == b.tokens
        assert 0.5 < s.acceptance_rate() <= 1.0


def test_draft_cache_holds_target_pages_after_every_sync(qwen_setup):
    """The draft proposer with the target's weights: after every
    ``_sync_all`` the draft pool holds, at every position it counts as
    synced, the target pool's bytes, though the sync writes them through
    ``prefill_all`` chunks and the target wrote the generated ones through
    verify rows: a row's arithmetic does not depend on the call's shape."""
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 12, 5))
    spec = SpecConfig(k=3, proposer="draft", draft_arch="qwen3-1.7b", draft_kv_dtype="mxfp4")
    eng = Engine(model, params, EngineConfig(n_slots=3, max_len=32, page_size=8,
                                             kv_dtype="mxfp4", prefill_chunk=8, spec=spec))
    prop, ps = eng.proposer, 8
    calls = {"prefill_all": 0}
    steps = prop._steps

    def counted(kind):
        fn = getattr(steps, kind)

        def call(*a):
            calls[kind] += 1
            return fn(*a)
        return call

    base_sync, compared = prop._sync_all, []

    def checked(decoding):
        prop._steps = steps._replace(**{k: counted(k) for k in calls})
        base_sync(decoding)
        prop._steps = steps
        for r in decoding:
            n = int(prop.synced[r.slot])
            assert n == r.prompt_len + len(r.tokens) - 1
            pos = torch.arange(n)
            for leaf, v in eng.cache.pool.items():
                mine = prop.cache.pool[leaf][:, torch.from_numpy(prop.cache.tables[r.slot])[
                    pos // ps].long(), pos % ps]
                want = v[:, torch.from_numpy(eng.cache.tables[r.slot])[pos // ps].long(),
                         pos % ps]
                assert torch.equal(mine, want), (r.rid, leaf)
            compared.append(n)

    prop._sync_all = checked
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.drain()
    assert all(r.acceptance_rate() == 1.0 for r in reqs)
    # the prompts (each slot on its first spec tick), then the one generated
    # position each fully accepted burst leaves behind
    assert calls["prefill_all"] > len(prompts) and len(compared) > len(prompts)


def test_spec_eos_mid_burst(qwen_setup):
    """EOS inside an accepted burst stops emission at once, as without
    speculation."""
    cfg, model, params = qwen_setup
    prompt = _prompts(cfg, lens=(9,), seed=6)[0]
    _, base = _run(model, params, [prompt], max_new=8)
    for eos in base[0].tokens[:2]:
        _, b = _run(model, params, [prompt], max_new=8, eos_id=eos)
        _, s = _run(model, params, [prompt], max_new=8, eos_id=eos,
                    spec=SpecConfig(k=3, proposer="self"))
        assert s[0].tokens == b[0].tokens
        assert s[0].finish_reason == "eos" and s[0].tokens[-1] == eos


def test_spec_rejects_non_paged_families(qwen_setup):
    cfg, model, params = qwen_setup
    for family in ("ssm", "hybrid"):
        other = Model(dataclasses.replace(cfg, family=family), model.forward, model.head)
        with pytest.raises(ValueError):
            Engine(other, params, EngineConfig(spec=SpecConfig(k=2)))
        with pytest.raises(ValueError):
            Engine(other, params, EngineConfig(prefix_cache=True))
    # MoE is a paged family: a reduced MoE model's engine takes speculation
    # and the prefix cache
    mcfg = kernel_config(get_reduced_config("qwen3-moe-235b-a22b"))
    moe = build_model(mcfg)
    mparams = init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(moe, mparams, EngineConfig(spec=SpecConfig(k=2), prefix_cache=True))
    assert eng.spec.k == 2 and eng.prefix is not None


def test_spec_full_pool_decode_to_budget(qwen_setup):
    """A pool sized exactly to the admitted reservations (no spare page) and
    prompt + max_new == max_len: speculative decode runs to the budget,
    mapping no page past a reservation."""
    cfg, model, params = qwen_setup
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(2)]
    ecfg = EngineConfig(n_slots=2, max_len=16, page_size=4, kv_dtype="mxfp4", prefill_chunk=4,
                        n_pages=1 + 2 * 4, spec=SpecConfig(k=3, proposer="self"),
                        debug_cache=True)
    eng = Engine(model, params, ecfg)
    handles = [eng.submit(p, 8) for p in prompts]
    reserved = eng.cache.pages_needed(16)
    while eng.sched.pending:
        eng.step()
        for req in eng.sched.active.values():
            assert eng.cache.mapped_pages(req.slot) <= reserved
    assert all(len(h.tokens) == 8 for h in handles)
    assert all(h.acceptance_rate() == 1.0 for h in handles)
    assert eng.cache.free_pages == eng.cache.n_pages - 1
    base = Engine(model, params, dataclasses.replace(ecfg, spec=None))
    bh = [base.submit(p, 8) for p in prompts]
    base.drain()
    assert [h.tokens for h in handles] == [h.tokens for h in bh]
    with pytest.raises(ValueError, match="n_pages"):
        Engine(model, params, dataclasses.replace(ecfg, n_pages=4))


# ---------------------------------------------------------------------------
# acceptance accounting on truncated and rejected bursts
# ---------------------------------------------------------------------------


def test_truncated_burst_accounting_budget(qwen_setup):
    cfg, model, params = qwen_setup
    # max_new 4, k 4: the one verify burst may emit only 3 of its 5 tokens
    _, hs = _run(model, params, _prompts(cfg, lens=(9,)), max_new=4,
                 spec=SpecConfig(k=4, proposer="self"))
    h = hs[0]
    assert len(h.tokens) == 4 and h.finish_reason == "max_tokens"
    assert h.draft_proposed == 3 and h.draft_accepted == 3
    assert h.acceptance_rate() == 1.0


def test_truncated_burst_accounting_eos(qwen_setup):
    cfg, model, params = qwen_setup
    prompt = _prompts(cfg, lens=(9,), seed=6)[0]
    ref = greedy_generate(model, params, torch.from_numpy(prompt)[None], max_new=8,
                          max_len=24)[0].tolist()
    _, base = _run(model, params, [prompt], max_new=8)
    assert base[0].tokens == ref
    # an EOS first reached in the decode phase, so a verify burst runs first
    eos = next(t for i, t in enumerate(ref[1:], 1) if t not in ref[:i])
    _, hs = _run(model, params, [prompt], max_new=8, eos_id=eos,
                 spec=SpecConfig(k=3, proposer="self"))
    h = hs[0]
    assert h.finish_reason == "eos" and h.tokens[-1] == eos
    assert h.draft_proposed > 0 and h.draft_accepted == h.draft_proposed


def test_rejected_burst_counts_all_drafts(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(9,))
    max_new, k = 5, 3
    _, base = _run(model, params, prompts, max_new=max_new)
    ref = base[0].tokens

    @register_proposer("_always_wrong")
    class AlwaysWrong(Proposer):
        def propose(self, decoding):
            drafts = np.zeros((self.engine.config.n_slots, self.spec.k), np.int32)
            for r in decoding:
                drafts[r.slot, :] = (ref[len(r.tokens)] + 1) % cfg.vocab_size
            return drafts

    _, hs = _run(model, params, prompts, max_new=max_new,
                 spec=SpecConfig(k=k, proposer="_always_wrong"))
    h = hs[0]
    assert h.tokens == ref
    # every burst emits one correction: 3 full bursts (k proposed each) and
    # the last, cut by the budget (1 emittable position)
    assert h.decode_calls == max_new - 1
    assert h.draft_proposed == k * (max_new - 2) + 1
    assert h.draft_accepted == 0 and h.acceptance_rate() == 0.0


def test_spec_rollback_monotone_and_bounded(qwen_setup):
    cfg, model, params = qwen_setup
    eng = Engine(model, params, EngineConfig(
        n_slots=3, max_len=32, page_size=8, kv_dtype="mxfp4", prefill_chunk=8,
        spec=SpecConfig(k=3, proposer="ngram"), debug_cache=True))
    handles = [eng.submit(p, 8) for p in _prompts(cfg, lens=(5, 11, 8))]
    seen: dict[int, int] = {}
    while eng.sched.pending:
        eng.step()
        for req in eng.sched.decoding():
            logical = req.prompt_len + len(req.tokens) - 1
            assert logical >= seen.get(req.rid, 0)
            seen[req.rid] = logical
            assert eng.cache.mapped_pages(req.slot) * eng.cache.page_size >= logical
            assert 0 <= req.draft_accepted <= req.draft_proposed
        assert eng.cache._free == sorted(eng.cache._free, reverse=True)
    assert all(h.done for h in handles)
    assert 0.0 <= aggregate_stats(handles)["acceptance_rate"] <= 1.0


# ---------------------------------------------------------------------------
# sampling and plain-decode accounting
# ---------------------------------------------------------------------------


def test_sampled_self_spec_matches_nonspec(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 12, 5))
    sp = SamplingParams(temperature=0.9, top_k=50, seed=5)
    for kv in ("dense", "mxfp4"):
        _, base = _run(model, params, prompts, kv=kv, sampling=sp)
        _, spec_h = _run(model, params, prompts, kv=kv, sampling=sp,
                         spec=SpecConfig(k=3, proposer="self"))
        for b, s in zip(base, spec_h):
            assert s.tokens == b.tokens
            assert s.acceptance_rate() == 1.0


def test_plain_decode_accounting(qwen_setup):
    cfg, model, params = qwen_setup
    _, hs = _run(model, params, _prompts(cfg, lens=(7, 10)))
    for h in hs:
        assert h.tokens_per_decode_call() == 1.0
        assert h.acceptance_rate() is None
        assert h.decode_calls == len(h.tokens) - 1
        assert h.latency() is not None and h.latency() >= h.ttft() >= 0
    agg = aggregate_stats(hs)
    assert agg == jaggregate_stats(hs)
    assert agg["tokens_per_decode_call"] == 1.0 and agg["acceptance_rate"] is None
