"""The enc-dec and VLM families served from the state pool's cross-KV plane
(whisper-tiny reduced: a 64-frame source; llama-3.2-vision-11b reduced: 64
image tokens, gates set), against the reference and the port's own oracle
on the CPU.

``StatePool``'s accounting with a cross plane (pages, bytes, bits an
element, occupancy, page stats, state bytes a decode step, admission with
and without an aliased cross set) equals the reference ``StatePool``'s
through admission and release.  The cross plane's write (every source
token of every layer quantize-scattered) of the same K/V equals the
reference's bit for bit, but where the reference's E8M0-nearest scale
misrounds near √2·2^k (ROADMAP C2), each such block asserted to be one;
its gather equals the reference's.  A dense plane holds, bit for bit, the
cross caches a ``build_cross`` prefill writes.  The engine on
``statepool`` with dense planes emits, token for token, what
``dense_slots`` emits (greedy and sampled, 5 requests on 3 slots); with
MXFP4 planes and the prefix cache a warm admission aliases the cold one's
cross pages, encodes nothing and emits the cold tokens, and new
conditioning encodes again; under pressure the cross index evicts
instead of wedging admission.  The gates: a missing conditioning raises,
the prefix cache is lifted for the cross families on ``statepool`` alone.
``cross_key`` hashes a bf16 tensor's raw bytes.  The ``cuda`` case holds
B4a and B4b at head dim 64 and the 1500- and 1600-token source scatters
to their plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import paged_cache as JP
from repro.serve.state_pool import StatePool as JStatePool
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params
from repro_torch.kernels import kv_pack as KV
from repro_torch.models import build_model
from repro_torch.serve import paged_cache as TP
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.state_pool import CrossIndex, StatePool, cross_key
from repro_torch.serve.steps import build_state_steps
from repro_torch.train.serve import make_chunk_prefill_step

ARCHS = ["whisper-tiny", "llama-3.2-vision-11b"]
KEY = {"whisper-tiny": "source_embeds", "llama-3.2-vision-11b": "image_embeds"}
PROMPTS = [np.random.default_rng(3).integers(0, 512, n).astype(np.int32)
           for n in (7, 12, 5, 9, 11)]
SAMPLING = [None, SamplingParams(temperature=0.9, top_k=8, seed=11), None,
            SamplingParams(temperature=1.3, top_p=0.9, seed=5), None]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extra(cfg, seed: int) -> dict:
    """One request's conditioning: bf16 standard normals from ``seed``."""
    n = cfg.max_source_len if cfg.family == "encdec" else cfg.num_image_tokens
    x = np.random.default_rng(seed).standard_normal((1, n, cfg.d_model)).astype(np.float32)
    return {KEY[cfg.name.removesuffix("-reduced")]: torch.from_numpy(x).to(torch.bfloat16)}


_MODELS = {}


def _setup(arch):
    """(cfg, model, params) of the reduced arch, the VLM's gates set."""
    if arch not in _MODELS:
        cfg = get_reduced_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if cfg.family == "vlm":
            params["cross_layers"]["gate_attn"].copy_(torch.tensor([0.5, -0.7]))
            params["cross_layers"]["gate_mlp"].copy_(torch.tensor([-0.3, 0.9]))
        _MODELS[arch] = cfg, build_model(cfg), params
    return _MODELS[arch]


def _accounting(sp, n_tokens):
    return {"cache_bytes": sp.cache_bytes(), "bits": sp.bits_per_element(),
            "occupancy": sp.occupancy(), "stats": sp.plane_stats(),
            "cross_tokens": sp.cross_tokens,
            "step": [sp.state_bytes_per_decode_step(n) for n in n_tokens],
            "dense_step": [sp.dense_state_bytes_per_decode_step(n) for n in n_tokens]}


@pytest.mark.parametrize("kv_dtype", ["mxfp4", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pool_accounting_equals_reference(arch, kv_dtype):
    """The same admissions (one aliasing another's cross set, as a warm
    admission does) and releases on both pools: equal accounting, tables
    and admission answers."""
    cfg = get_reduced_config(arch)
    kw = dict(n_slots=3, max_len=40, page_size=8, kv_dtype=kv_dtype)
    jsp = JStatePool(jbuild(jget_reduced(arch)), **kw)
    tsp = StatePool(build_model(cfg), device="cpu", **kw)
    assert not tsp.rings and tsp.cross.n_pages == jsp.cross.n_pages == 1 + 5 * 8
    for name in tsp.cross.pool:
        assert tuple(tsp.cross.pool[name].shape) == jsp.cross.pool[name].shape
    ns = (1, 8, 9, 40, 100)
    assert _accounting(tsp, ns) == _accounting(jsp, ns)
    shared = []
    for slot, n in ((0, 17), (2, 40), (1, 3)):
        for warm in (False, True):
            assert tsp.can_admit(n, cross_shared=warm) == jsp.can_admit(n, cross_shared=warm)
        tsp.alloc(slot, n, cross_shared=shared)
        jsp.alloc(slot, n, cross_shared=shared)
        assert _accounting(tsp, ns) == _accounting(jsp, ns)
        for t, j in ((tsp.kv, jsp.kv), (tsp.cross, jsp.cross)):
            np.testing.assert_array_equal(t.tables, j.tables)
            np.testing.assert_array_equal(t.refcounts, j.refcounts)
        shared = [int(p) for p in tsp.cross.tables[0]] if slot == 2 else []
    assert tsp.cross_publish("a", 0, 1.0) == jsp.cross_publish("a", 0, 1.0) == 8
    tsp.free(0)
    jsp.free(0)
    assert _accounting(tsp, ns) == _accounting(jsp, ns)
    assert tsp.cross_match("a", 2.0) == jsp.cross_match("a", 2.0)
    assert tsp.cross_index.evictable_pages(tsp.cross) == \
        jsp.cross_index.evictable_pages(jsp.cross) == 0  # slot 1 still aliases the set
    tsp.check_invariants()


def _c2_blocks(x: np.ndarray) -> np.ndarray:
    """[..., hd] rows → bool [..., hd/32]: the blocks whose absmax/6 lies
    within 16 f32 ulps of √2·2^k, where the reference's scale may misround
    (C2)."""
    amax = (np.abs(x.reshape(*x.shape[:-1], -1, 32)).max(-1) / np.float32(6.0)).astype(np.float32)
    near = np.float32(np.sqrt(2.0)) * np.exp2(np.floor(np.log2(np.maximum(amax, 2.0**-126))))
    return np.abs(amax.view(np.int32) - near.astype(np.float32).view(np.int32)) <= 16


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_plane_write_and_read_equal_the_reference_but_c2(arch):
    """The same K/V (the source's every token, every layer) scattered over
    one slot's cross pages by both packages' ``scatter_tokens``: equal codes
    and scales but in C2 blocks (none expected at these draws), and equal
    gathers in bf16."""
    cfg = get_reduced_config(arch)
    jsp = JStatePool(jbuild(jget_reduced(arch)), n_slots=2, max_len=16, page_size=8)
    tsp = StatePool(build_model(cfg), n_slots=2, max_len=16, page_size=8, device="cpu")
    jsp.alloc(1, 9)
    tsp.alloc(1, 9)
    L, H, hd = tsp.cross.layers, tsp.cross.kv_heads, tsp.cross.head_dim
    n = tsp.cross_tokens
    rng = np.random.default_rng(21)
    k, v = [(rng.standard_normal((L, n, H, hd)) * np.exp2(rng.integers(-4, 5, (L, n, H, 1))))
            .astype(np.float32) for _ in range(2)]
    pos = np.arange(n)
    row = tsp.cross.tables[1]
    jpool = jax.jit(JP.scatter_tokens)(jsp.cross.pool, jnp.asarray(row[pos // 8]), jnp.asarray(pos % 8),
                              jnp.asarray(k), jnp.asarray(v))
    TP.scatter_tokens(tsp.cross.pool, torch.from_numpy(row[pos // 8]),
                      torch.from_numpy(pos % 8), torch.from_numpy(k), torch.from_numpy(v))
    c2 = {"k": _c2_blocks(k), "v": _c2_blocks(v)}
    idx = row[pos // 8], pos % 8
    for name, got in tsp.cross.pool.items():
        want = np.asarray(jpool[name])[:, idx[0], idx[1]]
        got = got.numpy()[:, idx[0], idx[1]]
        if name.endswith("scales"):
            differ = got != want
        else:
            differ = (got != want).reshape(*got.shape[:-1], hd // 32, 16).any(-1)
        assert not (differ & ~c2[name[0]]).any(), name
    jk, jv = jax.jit(JP.gather_pages, static_argnums=2)(jpool, jnp.asarray(tsp.cross.tables[1:]), jnp.bfloat16)
    tk, tv = TP.gather_pages(tsp.cross.pool, torch.from_numpy(tsp.cross.tables[1:]),
                             torch.bfloat16)
    for g, w, c in ((tk, jk, c2["k"]), (tv, jv, c2["v"])):
        g = g[:, 0, :n].float().numpy()
        w = np.asarray(w[:, 0, :n], np.float32)
        ok = np.repeat(~c, 32, -1)
        np.testing.assert_array_equal(g[ok], w[ok])


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_plane_holds_the_build_cross_caches(arch):
    """The steps' ``encode_cross`` into a dense plane, gathered and sliced to
    the source's length, equals bit for bit the cross caches a dense-cache
    ``build_cross`` prefill chunk writes; into an MXFP4 plane it equals the
    plain quantization of those values."""
    cfg, model, params = _setup(arch)
    extra = _extra(cfg, 1)
    prompt = torch.from_numpy(PROMPTS[0][None])
    from repro_torch.train.serve import init_cache

    caches = init_cache(model, 1, 16, "cpu")
    make_chunk_prefill_step(model)(params, prompt, torch.zeros((1,), dtype=torch.int32), caches,
                                   extra)
    for kv_dtype in ("dense", "mxfp4"):
        sp = StatePool(model, n_slots=2, max_len=16, page_size=8, kv_dtype=kv_dtype,
                       device="cpu")
        sp.alloc(1, 9)
        steps = build_state_steps(model, method="quartet", pool=sp)
        row = torch.from_numpy(sp.cross.tables[1])
        steps.encode_cross(params, extra[KEY[arch]], row)
        k, v = TP.gather_pages(sp.cross.pool, row[None], torch.bfloat16)
        for got, want in ((k, caches["cross"][0]), (v, caches["cross"][1])):
            got = got[:, :, :sp.cross_tokens]
            if kv_dtype == "mxfp4":
                hd = want.shape[-1]
                want = KV.kv_dequant_unpack_plain(*KV.kv_quant_pack_plain(want.reshape(-1, hd)),
                                                  torch.bfloat16).reshape(want.shape)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), kv_dtype


def _run(arch, backend):
    """5 requests on 3 slots, dense planes, the plain bf16 products (the
    oracle's exactness does not depend on the method; QuEST is slower on
    the CPU)."""
    cfg, model, params = _setup(arch)
    eng = Engine(model, params, EngineConfig(
        n_slots=3, max_len=32, page_size=8, kv_dtype="dense", prefill_chunk=8,
        method="bf16", decode_backend=backend, debug_cache=True))
    hs = [eng.submit(p, 4, extra=_extra(cfg, i % 2), sampling=s)
          for i, (p, s) in enumerate(zip(PROMPTS, SAMPLING))]
    eng.drain()
    return eng, hs


@pytest.mark.parametrize("arch", ARCHS)
def test_statepool_dense_matches_dense_slots(arch):
    """Greedy and sampled requests, two sources, 5 requests on 3 slots:
    retired self- and cross-KV pages are reused and must not leak into a
    later request."""
    eng, pooled = _run(arch, "statepool")
    assert eng.decode_backend == "statepool" and eng.counters["cross_encode_calls"] == 5
    assert eng.cache.kv.free_pages == eng.cache.kv.n_pages - 1  # every page back
    assert eng.cache.cross.free_pages == eng.cache.cross.n_pages - 1
    _, oracle = _run(arch, "dense_slots")
    assert [h.tokens for h in pooled] == [h.tokens for h in oracle]
    assert all(len(h.tokens) == 4 for h in pooled)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_sharing_warm_exact_vs_cold(arch):
    """MXFP4 planes, the prefix cache on: a warm admission aliases the cold
    one's cross pages and emits the cold tokens, with one encode for three
    requests of one source; new conditioning encodes again."""
    cfg, model, params = _setup(arch)
    p1, p2 = PROMPTS[1], PROMPTS[3]
    ex = _extra(cfg, 7)
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                             kv_dtype="mxfp4", prefill_chunk=8,
                                             prefix_cache=True, debug_cache=True))
    assert eng.cross_share
    cold = eng.submit(p1, 5, extra=ex)
    eng.drain()
    warm = eng.submit(p1, 5, extra={k: v.clone() for k, v in ex.items()})  # equal bytes
    other = eng.submit(p2, 5, extra=ex)
    eng.drain()
    assert warm.tokens == cold.tokens and len(other.tokens) == 5
    c = eng.counters
    assert c["cross_encode_calls"] == 1 and c["prefix_hit_requests"] == 2
    assert c["prefix_shared_tokens"] == 2 * eng.cache.cross_tokens
    eng.submit(p1, 3, extra=_extra(cfg, 9))
    eng.drain()
    assert c["cross_encode_calls"] == 2 and c["prefix_lookups"] == 4
    eng.cache.check_invariants()


def test_cross_index_evicts_under_pressure():
    """Distinct sources pin page sets until the plane's headroom runs out;
    later admissions evict the least recently used unaliased set instead of
    wedging."""
    cfg, model, params = _setup("whisper-tiny")
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                             kv_dtype="mxfp4", prefill_chunk=8,
                                             prefix_cache=True, debug_cache=True))
    for i in range(6):
        h = eng.submit(PROMPTS[2][:6], 2, extra=_extra(cfg, 100 + i))
        eng.drain()
        assert len(h.tokens) == 2
    eng.cache.check_invariants()
    assert eng.counters["cross_encode_calls"] == 6
    # headroom 2 beyond 2 slots: at most 4 sets cached at once
    assert len(eng.cache.cross_index) <= 4
    assert eng.cache.cross_index.cached_pages() == 8 * len(eng.cache.cross_index)


def test_cross_index_lru_and_pins():
    """``CrossIndex`` alone: publish pins, match touches, eviction drops the
    least recently used entry whose pages no slot maps, and honours
    ``exclude``."""
    cfg, model, _ = _setup("whisper-tiny")
    sp = StatePool(model, n_slots=2, max_len=16, page_size=8, device="cpu", cross_headroom=1)
    idx = sp.cross_index
    assert isinstance(idx, CrossIndex)
    for slot, key, t in ((0, "a", 1.0), (1, "b", 2.0)):
        sp.alloc(slot, 8)
        assert sp.cross_publish(key, slot, t) == 8
    assert sp.cross_publish("a", 0, 3.0) == 0  # already in
    assert idx.evictable_pages(sp.cross) == 0  # both still mapped
    sp.free(0)
    sp.free(1)
    assert idx.evictable_pages(sp.cross) == 16
    assert idx.match("a", 5.0)  # a is now the most recently used
    assert idx.evict(sp.cross, 1, exclude={"b"}) == 8 and len(idx) == 1
    assert idx.match("a", 6.0) == [] and idx.match("b", 6.0)
    assert sp.cross.free_pages == 16 and sp.can_admit(8)
    sp.alloc(0, 8)
    sp.alloc(1, 8)
    assert sp.cross_publish("c", 1, 7.0) == 8
    sp.free(0)
    sp.free(1)
    sp.alloc(0, 8)  # the free list holds one set
    sp.alloc(1, 8)  # none left: b, used before c, is evicted
    assert len(idx) == 1 and idx.match("c", 8.0) and sp.cross.free_pages == 0
    sp.check_invariants()


def test_gates_for_the_cross_families():
    for arch in ARCHS:
        cfg, model, params = _setup(arch)
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8))
        with pytest.raises(ValueError, match=KEY[arch]):
            eng.submit(PROMPTS[0], 2)  # the cross-KV is encoded at admission
        assert Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                                  prefix_cache=True)).cross_share
        with pytest.raises(ValueError, match="shareable pages"):
            Engine(model, params, EngineConfig(prefix_cache=True, decode_backend="dense_slots"))
        with pytest.raises(ValueError, match="dense_slots"):
            Engine(model, params, EngineConfig(decode_backend="paged"))
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        cfg = get_reduced_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="shareable pages"):
            Engine(build_model(cfg), params, EngineConfig(prefix_cache=True))


def test_cross_key_hashes_raw_bytes():
    x = torch.randn((1, 64, 32), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    k = cross_key({"image_embeds": x})
    assert k == cross_key({"image_embeds": x.clone()})
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    assert k == cross_key({"image_embeds": strided})  # the bytes of the values
    y = x.clone()
    y.view(torch.int16)[0, 5, 7] ^= 1  # one bit
    assert cross_key({"image_embeds": y}) != k
    assert cross_key({"source_embeds": x}) != k  # the name is hashed too
    assert cross_key({"image_embeds": x.reshape(1, 32, 64)}) != k  # and the shape
    f = np.random.default_rng(0).standard_normal((1, 4, 8)).astype(np.float32)
    assert cross_key({"a": f}) == cross_key({"a": torch.from_numpy(f)})
    assert cross_key(None) is None and cross_key({"a": None}) is None


@pytest.mark.cuda
def test_hd64_and_source_scatters_on_card():
    """B4a and B4b at hd 64 (two blocks a head) and each cross plane's scatter
    of a whole source (whisper-tiny's 1500 × 4 layers × 6 heads of 64, the
    VLM's 1600 × 8 × 8 of 128) in one launch, and its gather sliced to the
    source, bit for bit against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch in ARCHS:
        cfg = get_config(arch)
        L = cfg.num_layers if cfg.family == "encdec" else cfg.num_layers // cfg.cross_attn_every
        n = cfg.max_source_len if cfg.family == "encdec" else cfg.num_image_tokens
        H, hd = cfg.num_kv_heads, cfg.head_dim_
        cpp = -(-n // 16)
        n_pages = 1 + 3 * cpp
        row = 1 + torch.randperm(n_pages - 1, generator=gen, device="cuda")[:cpp].to(torch.int32)
        pos = torch.arange(n, device="cuda")
        k, v = [(torch.randn((L, n, H, hd), generator=gen, device="cuda") * 3).to(torch.bfloat16)
                for _ in range(2)]
        leaves = [torch.zeros((L, n_pages, 16, H, w), dtype=torch.uint8, device="cuda")
                  for w in (hd // 2, hd // 32, hd // 2, hd // 32)]
        before = (KV.kv_quant_pack.launches, KV.kv_dequant_unpack.launches)
        KV.kv_quant_scatter_kv(*leaves, row[pos // 16], pos % 16, k, v)
        pool = dict(zip(("k_codes", "k_scales", "v_codes", "v_scales"), leaves))
        gk, gv = TP.gather_pages(pool, row[None], torch.bfloat16)
        assert (KV.kv_quant_pack.launches - before[0],
                KV.kv_dequant_unpack.launches - before[1]) == (1, 1)
        for g, x in ((gk, k), (gv, v)):
            c, s = KV.kv_quant_pack_plain(x.reshape(-1, hd))
            want = KV.kv_dequant_unpack_plain(c, s, torch.bfloat16).reshape(L, n, H, hd)
            assert torch.equal(g[:, 0, :n].view(torch.int16), want.view(torch.int16)), arch
