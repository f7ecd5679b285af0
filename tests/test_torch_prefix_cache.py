"""PyTorch port vs the JAX reference: the radix prefix cache.

Host level, against the reference's own objects: each schedule of
``tests/test_prefix_cache.py``'s allocator and index tests (aliasing,
external pins, copy-on-write, the invariant checker, radix insert / match,
LRU eviction with an exclude set, eviction of a mapped page) runs on the
reference's ``PagedCache`` + ``PrefixIndex`` and on the port's, and the
page ids, refcounts, free lists and returned counts are equal at every
step; an admission loop under pool pressure (match, evict, alias, publish,
retire) gives equal tables and counts on both.

Engine level, inside the port: enabling ``prefix_cache`` leaves the tokens
unchanged (warm == cold) on both pools, both backends, with and without
self-speculation — except the MXFP4 pool on the gather backend, which the
reference excludes too (its prefill attends over its own chunk before
quantization, and a warm admission changes the chunking) — with the
engine's counts equal to the ones the schedule predicts; the cached pages
stay bit-stable under decode and speculative rollback; a full index is
evicted rather than wedging admission.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import PagedCache as JPagedCache
from repro.serve import PrefixIndex as JPrefixIndex
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, PagedCache, PrefixIndex, SpecConfig

pytestmark = pytest.mark.prefix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = get_reduced_config("qwen3-1.7b")
JMODEL = jbuild(jget_reduced("qwen3-1.7b"))


def _caches(**kw):
    """The reference's cache and the port's, same geometry, debug on."""
    kw = {"n_slots": 2, "pages_per_slot": 4, "page_size": 4, "kv_dtype": "dense",
          "debug": True, **kw}
    return JPagedCache(JMODEL, **kw), PagedCache(CFG, device="cpu", **kw)


def _state(cache) -> tuple:
    return (cache.tables.tolist(), cache.refcounts.tolist(), list(cache._free),
            cache.live_pages(), cache.mapped_total(), cache.page_mask().tolist())


def _twin(schedule, **kw):
    """Run ``schedule(cache, index_cls, log)`` on both packages; their logs
    (returned values and allocator states) must be equal."""
    logs = []
    for cache, index_cls in zip(_caches(**kw), (JPrefixIndex, PrefixIndex)):
        log = []
        schedule(cache, index_cls, lambda *x, c=cache, log=log: log.append((x, _state(c))))
        logs.append(log)
    assert logs[0] == logs[1]
    return logs[1]


def test_refcounted_alias_and_free():
    def schedule(cache, _, log):
        total = cache.n_pages - 1
        cache.alloc(0, 9)  # 3 pages
        shared = [int(p) for p in cache.tables[0][:2]]
        cache.alloc(1, 12, shared=shared)  # alias 2, 1 fresh
        log("alias", cache.free_pages, shared)
        assert cache.free_pages == total - 4
        assert all(int(cache.refcounts[p]) == 2 for p in shared)
        cache.free(0)  # shared pages survive: slot 1 still maps them
        log("free 0", cache.free_pages)
        assert all(int(cache.refcounts[p]) == 1 for p in shared)
        cache.free(1)
        log("free 1", cache.free_pages)
        assert cache.free_pages == total
        cache.check_invariants()

    _twin(schedule)


def test_external_pin_keeps_page_alive():
    def schedule(cache, _, log):
        total = cache.n_pages - 1
        cache.alloc(0, 4)
        pid = int(cache.tables[0][0])
        cache.ref_page(pid)  # the prefix index's pin
        cache.free(0)
        log("pinned", int(cache.refcounts[pid]), cache.free_pages)
        assert int(cache.refcounts[pid]) == 1 and cache.free_pages == total - 1
        assert cache.unref_page(pid)  # last holder → page frees
        log("unpinned", cache.free_pages)
        with pytest.raises(ValueError):
            cache.unref_page(pid)
        with pytest.raises(ValueError):
            cache.ref_page(pid)

    _twin(schedule)


def test_cow_copies_payload_and_remaps_writer():
    def schedule(cache, _, log):
        cache.alloc(0, 8)  # 2 pages
        src = int(cache.tables[0][0])
        if isinstance(cache, PagedCache):
            cache.pool["k"][:, src] = 7.0
            payload = lambda p: cache.pool["k"][:, p].float().numpy()  # noqa: E731
        else:
            k = np.zeros(cache.pool["k"].shape, np.float32)
            k[:, src] = 7.0
            cache.pool = {**cache.pool, "k": jnp.asarray(k, cache.pool["k"].dtype)}
            payload = lambda p: np.asarray(cache.pool["k"][:, p], np.float32)  # noqa: E731
        cache.alloc(1, 8, shared=[src])
        copied = cache.cow_range(1, 0, 3)  # slot 1 about to write tokens 0..2
        dst = int(cache.tables[1][0])
        log("cow", copied, src, dst)
        assert copied == 1 and dst != src
        np.testing.assert_array_equal(payload(dst), payload(src))
        assert (payload(dst) == 7.0).all()
        assert cache.cow_range(1, 0, 8) == 0  # exclusively owned: no copy
        log("owned")
        cache.check_invariants()

    _twin(schedule)


def test_invariant_checker_catches_corruption():
    def schedule(cache, _, log):
        cache.alloc(0, 4)
        cache.check_invariants()
        cache.refcounts[int(cache.tables[0][0])] += 1
        with pytest.raises(AssertionError, match="refcount mismatch"):
            cache.check_invariants()
        cache.refcounts[int(cache.tables[0][0])] -= 1
        cache._free.append(int(cache.tables[0][0]))  # a freed page still mapped
        cache._free.sort(reverse=True)
        with pytest.raises(AssertionError):
            cache.check_invariants()
        log("caught")

    _twin(schedule, debug=False)


def test_radix_insert_match_full_pages_only():
    def schedule(cache, index_cls, log):
        idx = index_cls(page_size=4)
        toks = np.arange(10, dtype=np.int32)  # 2 full pages + a 2-token tail
        cache.alloc(0, 10)
        log("insert", idx.insert(cache, toks, cache.tables[0], stamp=1.0), idx.cached_pages())
        full = idx.match(toks, 2.0)
        log("match", full, idx.match(toks[:8], 2.0), idx.match(toks[:6], 2.0))
        assert full == [int(p) for p in cache.tables[0][:2]]
        assert idx.match(toks[:8], 2.0) == full  # the partial tail page is never indexed
        assert idx.match(toks[:6], 2.0) == [int(cache.tables[0][0])]
        # the same chunk under another prefix must not match
        assert idx.match(np.concatenate([toks[4:8], toks[4:8]]), 2.0) == []
        cache.alloc(1, 8, shared=idx.match(toks, 3.0))
        log("reinsert", idx.insert(cache, toks[:8], cache.tables[1], stamp=3.0))

    _twin(schedule)


def test_radix_lru_eviction_and_exclude():
    def schedule(cache, index_cls, log):
        idx = index_cls(page_size=4)
        a, b = np.arange(8, dtype=np.int32), np.arange(100, 108, dtype=np.int32)
        cache.alloc(0, 8)
        idx.insert(cache, a, cache.tables[0], stamp=1.0)
        pages_a = idx.match(a, 1.0)
        cache.free(0)
        cache.alloc(0, 8)
        idx.insert(cache, b, cache.tables[0], stamp=2.0)
        pages_b = idx.match(b, 2.0)
        cache.free(0)
        log("evictable", idx.evictable_pages(cache), idx.evictable_pages(cache, exclude=pages_a))
        assert idx.evictable_pages(cache) == 4
        # chain a is older, but its leaf goes first
        log("evict 1", idx.evict(cache, 1), idx.match(a, 3.0), idx.match(b, 3.0))
        assert idx.match(a, 3.0) == pages_a[:1] and idx.match(b, 3.0) == pages_b
        freed = idx.evict(cache, 2, exclude=pages_a[:1])  # drains chain b
        log("evict 2", freed, idx.match(b, 4.0), idx.match(a, 4.0))
        assert freed == 2 and idx.match(b, 4.0) == []
        idx.evict(cache, cache.n_pages)
        log("evict all", idx.cached_pages())
        assert idx.cached_pages() == 0 and cache.free_pages == cache.n_pages - 1

    _twin(schedule, pages_per_slot=6, n_pages=13)


def test_evicting_mapped_page_frees_nothing_until_retire():
    def schedule(cache, index_cls, log):
        idx = index_cls(page_size=4)
        cache.alloc(0, 4)
        idx.insert(cache, np.arange(4, dtype=np.int32), cache.tables[0], stamp=1.0)
        pid = int(cache.tables[0][0])
        log("evict", idx.evict(cache, 1), int(cache.refcounts[pid]))
        assert int(cache.refcounts[pid]) == 1  # the slot still maps it
        cache.free(0)
        log("retired", cache.free_pages)
        assert cache.free_pages == cache.n_pages - 1

    _twin(schedule)


def test_admission_under_pool_pressure_matches_reference():
    """The engine's admission protocol on the allocator alone: match, evict
    the shortfall (the match excluded), alias, publish the prompt, publish
    the conversation at retirement, free — 6 requests of 9 prompt tokens +
    3 generated through a pool of 2 x 4 pages of 4 tokens.  Tables, counts
    and evictions equal the reference's at every step."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, 9).astype(np.int32) for _ in range(6)]
    prompts[3][:8] = prompts[1][:8]  # a two-page hit
    prompts[5] = prompts[3].copy()  # a full-prompt hit on a published chain
    gen = rng.integers(0, 512, (6, 3)).astype(np.int32)

    def schedule(cache, index_cls, log):
        idx = index_cls(page_size=4)
        for i, p in enumerate(prompts):
            match = idx.match(p, float(i))
            need = cache.pages_needed(p.size + 3) - len(match) + (len(match) * 4 == p.size)
            evicted = 0
            if need > cache.free_pages:
                evicted = idx.evict(cache, need - cache.free_pages, exclude=match)
            cache.alloc(0, p.size + 3, shared=match)
            cow = cache.cow_range(0, p.size - 1, 1) if len(match) * 4 == p.size else 0
            ins = idx.insert(cache, p, cache.tables[0], float(i))
            chain = np.concatenate([p, gen[i, :2]])
            ins += idx.insert(cache, chain, cache.tables[0], float(i) + 0.5)
            log(i, match, evicted, cow, ins, idx.cached_pages(),
                idx.evictable_pages(cache))
            cache.free(0)
        log("end", idx.evict(cache, cache.n_pages))
        assert cache.free_pages == cache.n_pages - 1

    log = _twin(schedule, n_slots=1, pages_per_slot=4, n_pages=9)
    assert sum(e[0][2] for e in log[:-1]) > 0  # the index was evicted
    assert [len(e[0][1]) for e in log[:-1]] == [0, 0, 0, 2, 0, 2]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_setup():
    cfg = kernel_config(get_reduced_config("qwen3-1.7b"))
    return cfg, build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _run_engine(model, params, waves, *, kv, backend, spec=False, prefix=False, max_new=4,
                n_slots=2, page_size=8):
    eng = Engine(model, params, EngineConfig(
        n_slots=n_slots, max_len=48, page_size=page_size, kv_dtype=kv,
        prefill_chunk=page_size, decode_backend=backend, prefix_cache=prefix,
        debug_cache=True, spec=SpecConfig(k=3, proposer="self") if spec else None))
    out = []
    for wave in waves:
        handles = [eng.submit(p, max_new) for p in wave]
        eng.drain()
        out.append([h.tokens for h in handles])
    return eng, out


def _shared_prefix_waves(cfg, page_size=8):
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 2 * page_size).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 5)]
    # wave 0 publishes the prefix; wave 1 hits it, with a pure-prefix prompt
    # (a full match: the last shared page is copied before its rewrite)
    return [[np.concatenate([prefix, tails[0]])],
            [prefix.copy(), np.concatenate([prefix, tails[1]])]]


# the schedule's counts: wave 0 (19 tokens) publishes 2 full pages; wave 1's
# pure prefix (16) hits both pages, copies the second and prefills 1 token
# (15 shared), its 21-token prompt hits both (16 shared) and publishes a
# third page at retirement (21 + 3 consumed tokens)
WARM_COUNTS = {"prefix_lookups": 3, "prefix_hit_requests": 2, "prefix_shared_tokens": 31,
               "prefix_inserted_pages": 3, "prefix_evicted_pages": 0, "prefix_cow_pages": 1}


@pytest.mark.parametrize("kv", ["dense", "mxfp4"])
@pytest.mark.parametrize("backend", ["paged", "gather"])
@pytest.mark.parametrize("spec", [False, True])
def test_warm_vs_cold_token_exact(qwen_setup, kv, backend, spec):
    cfg, model, params = qwen_setup
    waves = _shared_prefix_waves(cfg)
    warm_eng, warm = _run_engine(model, params, waves, kv=kv, backend=backend, spec=spec,
                                 prefix=True)
    cold_eng, cold = _run_engine(model, params, waves, kv=kv, backend=backend, spec=spec)
    if not (kv == "mxfp4" and backend == "gather"):
        assert warm == cold, (kv, backend, spec)
    counts = {k: warm_eng.telemetry.registry.counter(k).value for k in WARM_COUNTS}
    assert counts == WARM_COUNTS
    assert not any(cold_eng.telemetry.registry.counter(k).value for k in WARM_COUNTS)
    warm_eng.cache.check_invariants()
    if spec:
        rate = warm_eng.telemetry.registry.gauge("spec_acceptance_rate").value
        assert rate == 1.0 or kv == "mxfp4"


def test_cached_payload_immutable_under_decode_and_spec(qwen_setup):
    """Copy-on-write keeps the published pages bit-stable: requests that
    alias the prefix and then decode (or roll back speculatively) past it
    never change the payload the other holders see."""
    cfg, model, params = qwen_setup
    for spec in (False, True):
        waves = _shared_prefix_waves(cfg)
        eng, _ = _run_engine(model, params, waves[:1], kv="mxfp4", backend="paged", spec=spec,
                             prefix=True)
        pages = eng.prefix.match(waves[1][0], 0.0)
        assert len(pages) == 2
        before = {name: arr[:, pages].clone() for name, arr in eng.cache.pool.items()}
        for p in waves[1]:
            eng.submit(p, 6)
        eng.drain()
        assert eng.prefix.match(waves[1][0], 0.0) == pages
        for name, arr in eng.cache.pool.items():
            assert torch.equal(before[name], arr[:, pages]), (name, spec)
        eng.cache.check_invariants()


def test_eviction_under_pool_pressure(qwen_setup):
    """A full radix index does not wedge admission: the engine LRU-evicts
    cached prefixes to make room, and page conservation holds throughout."""
    cfg, model, params = qwen_setup
    rng = np.random.default_rng(13)
    eng = Engine(model, params, EngineConfig(
        n_slots=2, max_len=16, page_size=4, kv_dtype="mxfp4", prefill_chunk=4,
        decode_backend="paged", prefix_cache=True, debug_cache=True))
    handles = []
    for _ in range(6):
        handles.append(eng.submit(rng.integers(0, cfg.vocab_size, 9).astype(np.int32), 3))
        eng.drain()
    assert all(len(h.tokens) == 3 for h in handles)
    assert eng.telemetry.registry.counter("prefix_evicted_pages").value > 0
    cache = eng.cache
    cache.check_invariants()
    assert cache.live_pages() + cache.free_pages == cache.n_pages - 1
    eng.prefix.evict(cache, cache.n_pages)  # dropping the index leaks nothing
    assert cache.free_pages == cache.n_pages - 1
