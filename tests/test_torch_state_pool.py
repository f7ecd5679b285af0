"""The state pool (the SSM family's quantized state rings) against the
reference, and its engine backends against the dense-slot oracle.

``core.quantizers.state_quantize`` equals the reference's bit for bit but
where the reference's E8M0-nearest scale misrounds near √2·2^k (ROADMAP
C2): each differing block is asserted to be such a misround.  The rings'
sentinel and cursor contracts are the reference's
(``tests/test_state_pool.py``).  ``Engine`` on ``statepool`` with
``kv_dtype="dense"`` emits, token for token, what ``dense_slots`` emits,
with more requests than slots and sampled requests; with MXFP4 rings each
ring page holds one quantize pass of its state.  Speculation and the
prefix cache raise for the SSM family.  The kernels' half (B4a and B4b on
the ring views, on the card) is the ``cuda``-marked case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as JQ
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.kernels import kv_pack as KV
from repro_torch.models import build_model
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.spec.config import SpecConfig
from repro_torch.serve.state_pool import RING_DEPTH, RingPlane, StatePool, ring_rows

ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ssm():
    cfg = get_reduced_config(ARCH)
    return cfg, build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _states(n: int) -> np.ndarray:
    """[4, n] flat states: Gaussian rows at four scales, plus blocks whose
    absmax/6 sits within ±8 ulps of √2·2^k (where the reference's
    E8M0-nearest misrounds, C2) and an all-zero block."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((4, n)) * np.array([[1e-3], [1.0], [30.0], [1e4]])).astype(np.float32)
    for b in range(min(n // 32, 24)):
        k = int(rng.integers(-10, 10))
        top = np.float32(np.sqrt(2.0) * 2.0 ** k).view(np.int32) + int(rng.integers(-8, 9))
        x[1, 32 * b:32 * b + 32] = x[1, 32 * b:32 * b + 32] / 10 * top.view(np.float32) * 6
        x[1, 32 * b] = top.view(np.float32) * np.float32(6.0)
    x[2, :32] = 0.0
    return x


@pytest.mark.parametrize("n", [1536, 4096, 105])
def test_state_quantize_matches_reference_but_c2(n):
    x = _states(n)
    want = JQ.state_quantize(jnp.asarray(x))
    got = Q.state_quantize(torch.from_numpy(x))
    js, ts = np.asarray(want.scales), got.scales.numpy()
    assert ts.shape == js.shape == (4, -(-n // 32))
    differ = js != ts
    pad = np.pad(x, ((0, 0), (0, (-n) % 32))).reshape(4, -1, 32)
    amax = np.abs(pad).max(-1) / np.float32(6.0)
    exact = F.scale_to_e8m0_code(torch.from_numpy(np.exp2(np.clip(np.round(np.log2(
        np.maximum(amax.astype(np.float64), 2.0 ** -126))), -126, 127)).astype(np.float32)))
    np.testing.assert_array_equal(ts, exact.numpy())  # the port: the exact nearest power
    for r, b in zip(*np.nonzero(differ)):  # the reference: misrounds near √2·2^k only
        near = np.float32(np.sqrt(2.0) * 2.0 ** np.floor(np.log2(amax[r, b]))).view(np.int32)
        assert abs(int(amax[r, b].view(np.int32)) - int(near)) <= 16, (r, b, amax[r, b])
    codes_ok = np.repeat(~differ, 16, axis=1)
    np.testing.assert_array_equal(got.codes.numpy()[codes_ok], np.asarray(want.codes)[codes_ok])
    assert differ.sum() < 24  # a few edge blocks, never the Gaussian rows
    if n >= 1536:
        assert differ.sum() > 0  # the sweep reaches the reference's misrounds
    back = Q.state_dequantize(got, n, dtype=torch.float32)
    jback = np.asarray(JQ.state_dequantize(want, n, dtype=jnp.float32))
    assert back.shape == (4, n)
    ok = np.repeat(~differ, 32, axis=1)[:, :n]
    np.testing.assert_array_equal(back.numpy()[ok], jback[ok])


@pytest.mark.parametrize("kv_dtype", ["dense", "mxfp4"])
def test_ring_plane_roundtrip_and_sentinel(kv_dtype):
    leaf = (3, 5, 7)  # [layers, *state]: deliberately not a multiple of 32
    plane = RingPlane(leaf, torch.float32, 2, kv_dtype, "cpu")
    assert plane.padded == 128 and plane.row == 128
    fresh = plane.gather(torch.zeros(2, dtype=torch.int32))
    assert fresh.shape == (3, 2, 5, 7) and not fresh.any()  # page 0: the zero sentinel
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 2, 5, 7)).astype(np.float32))
    write = torch.tensor([1, 3], dtype=torch.int32)
    plane.scatter(write, x)
    y = plane.gather(write)
    if kv_dtype == "dense":
        assert torch.equal(y, x)
    else:  # one quantize-on-write pass: the reference's state round trip
        flat = x.movedim(1, 0).reshape(2, -1)
        ref = Q.state_dequantize(Q.state_quantize(flat), flat.shape[-1])
        assert torch.equal(y.movedim(1, 0).reshape(2, -1), ref)
        assert plane.page_bytes() * 8 / plane.padded == 4.25
    plane.scatter(torch.tensor([0, 3], dtype=torch.int32), torch.zeros_like(x))
    again = plane.gather(write)  # a sentinel write leaves the live pages
    assert torch.equal(again[:, 0], y[:, 0]) and not again[:, 1].any()


def test_ring_rows_divide_and_view_independent():
    """The 2-d view's rows: whole blocks, a power of two up to 4096; the
    bits do not depend on the view (blocks are independent)."""
    assert ring_rows(64 * 3 * 8192) == 4096 and ring_rows(64 * 8192 * 16) == 4096
    assert ring_rows(1536) == 512 and ring_rows(96) == 32
    x = torch.from_numpy(_states(4096))
    c1, s1 = KV.kv_quant_pack(x.reshape(-1, 4096))
    c2, s2 = KV.kv_quant_pack(x.reshape(-1, 32))
    assert torch.equal(c1.reshape(-1), c2.reshape(-1)) and torch.equal(s1.reshape(-1),
                                                                       s2.reshape(-1))


def test_ring_cursor_contract(ssm):
    _, model, _ = ssm
    sp = StatePool(model, n_slots=2, max_len=16, device="cpu")
    assert len(sp.rings) == 2
    assert sp.rings[0].leaf_shape == (2, 3, 256) and sp.rings[1].leaf_shape == (2, 256, 8)
    sp.alloc(0, 16)
    mask = np.array([True, False])
    read0, write0 = sp.ring_ids(mask)
    assert read0[0] == 0  # a fresh slot reads the zero sentinel
    assert read0[1] == 0 and write0[1] == 0  # a masked lane: the sentinel page
    w = sp.ring_write_id(0)
    assert write0[0] == w and w != 0
    sp.ring_advance(mask)
    read1, write1 = sp.ring_ids(mask)
    assert read1[0] == w  # reads what was just written
    assert write1[0] not in (0, w)  # the double buffer: the write page flips
    sp.ring_advance(mask)
    read2, write2 = sp.ring_ids(mask)
    assert read2[0] == write1[0] and write2[0] == w
    assert {w, write1[0]} == {1, 2} and RING_DEPTH == 2  # slot 0 owns pages 1 and 2
    sp.check_invariants()
    sp.ring_read[0] = 4  # another slot's page
    with pytest.raises(AssertionError, match="not the sentinel"):
        sp.check_invariants()
    sp.ring_read[0] = read2[0]
    sp.free(0)
    sp.check_invariants()
    assert sp.ring_ids(mask)[0][0] == 0  # released: the sentinel again


def test_statepool_bytes_win(ssm):
    """Packed per-step state traffic beats the dense caches ≥ 4x (4.25
    bits an element against bf16 conv and f32 h)."""
    _, model, _ = ssm
    sp = StatePool(model, n_slots=4, max_len=64, device="cpu")
    assert sp.dense_state_bytes_per_decode_step(64) >= 4 * sp.state_bytes_per_decode_step(64)
    assert sp.bits_per_element() == 4.25
    dense = StatePool(model, n_slots=4, max_len=64, kv_dtype="dense", device="cpu")
    assert dense.cache_bytes() == sum(r.n_pages * r.padded * (2 if i == 0 else 4)
                                      for i, r in enumerate(dense.rings))


PROMPTS = [np.random.default_rng(3).integers(0, 512, n).astype(np.int32)
           for n in (7, 12, 5, 9, 11)]
SAMPLING = [None, SamplingParams(temperature=0.9, top_k=8, seed=11), None,
            SamplingParams(temperature=1.3, top_p=0.9, seed=5), None]


def _run(model, params, backend, kv_dtype="dense", method="quartet"):
    eng = Engine(model, params, EngineConfig(
        n_slots=3, max_len=32, page_size=8, kv_dtype=kv_dtype, prefill_chunk=8,
        decode_backend=backend, debug_cache=True, method=method))
    hs = [eng.submit(p, 4, sampling=s) for p, s in zip(PROMPTS, SAMPLING)]
    eng.drain()
    return eng, [h.tokens for h in hs]


@pytest.mark.parametrize("method", ["quartet", "bf16"])
def test_statepool_dense_matches_dense_slots(ssm, method):
    """Greedy and sampled requests, prompts of other lengths, 5 requests on
    3 slots (retired rings are reused and must not leak into a later
    request)."""
    _, model, params = ssm
    eng, pooled = _run(model, params, "statepool", method=method)
    assert eng.decode_backend == "statepool" and isinstance(eng.cache, StatePool)
    eng.cache.check_invariants()
    oracle_eng, oracle = _run(model, params, "dense_slots", method=method)
    assert oracle_eng.decode_backend == "dense_slots"
    assert pooled == oracle
    assert all(len(t) == 4 for t in pooled)


def test_statepool_mxfp4_serves(ssm):
    """The default backend and pool: every request completes; the engine's
    state bytes are the packed rings'."""
    _, model, params = ssm
    eng, toks = _run(model, params, None, kv_dtype="mxfp4")
    assert eng.decode_backend == "statepool" and all(len(t) == 4 for t in toks)
    assert all(0 <= t < 512 for ts in toks for t in ts)
    assert eng.cache_bytes() == eng.cache.cache_bytes() > 0
    assert not eng.cache.ring_active.any()


def test_gates_for_the_ssm_family(ssm):
    cfg, model, params = ssm
    with pytest.raises(ValueError, match="one token per state"):
        Engine(model, params, EngineConfig(spec=SpecConfig(k=2)))
    with pytest.raises(ValueError, match="prefix caching"):
        Engine(model, params, EngineConfig(prefix_cache=True))
    with pytest.raises(ValueError, match="statepool"):
        Engine(model, params, EngineConfig(decode_backend="paged"))
    qwen = build_model(get_reduced_config("qwen3-1.7b"))
    with pytest.raises(ValueError, match="dense/moe use PagedCache"):
        StatePool(qwen, n_slots=2, max_len=16, device="cpu")
    # the enc-dec family's pool now carries its cross-KV plane (no rings)
    encdec = StatePool(build_model(get_reduced_config("whisper-tiny")), n_slots=2, max_len=16,
                       device="cpu")
    assert encdec.cross is not None and encdec.cross_tokens == 64 and not encdec.rings


@pytest.mark.cuda
def test_b4a_b4b_on_ring_views_on_card():
    """B4a and B4b through their 2-d entries on the ring pages' views, bit
    for bit against their plain versions run on the card (one launch each),
    and a ring's scatter/gather on the card equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for n in (1536, 4096, 64 * 3 * 256):
        x = torch.from_numpy(_states(n))
        rows = x.reshape(-1, ring_rows(n)).cuda()
        before = (KV.kv_quant_pack.launches, KV.kv_dequant_unpack.launches)
        c, s = KV.kv_quant_pack(rows)
        pc, ps = KV.kv_quant_pack_plain(rows)
        assert torch.equal(c, pc) and torch.equal(s, ps)
        for dt in (torch.float32, torch.bfloat16):
            y = KV.kv_dequant_unpack(c, s, dt)
            assert torch.equal(y.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                               KV.kv_dequant_unpack_plain(c, s, dt).view(
                                   torch.int16 if dt == torch.bfloat16 else torch.int32))
        assert (KV.kv_quant_pack.launches - before[0], KV.kv_dequant_unpack.launches
                - before[1]) == (1, 2)
    leaf = (2, 3, 256)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 3, 256))
                         .astype(np.float32)).to(torch.bfloat16)
    ids = torch.tensor([1, 0, 5], dtype=torch.int32)
    planes = {d: RingPlane(leaf, torch.bfloat16, 3, "mxfp4", d) for d in ("cpu", "cuda")}
    for d, p in planes.items():
        p.scatter(ids.to(d), x.to(d))
    card, host = planes["cuda"], planes["cpu"]
    assert torch.equal(card.pool["codes"].cpu(), host.pool["codes"])
    assert torch.equal(card.pool["scales"].cpu(), host.pool["scales"])
    assert torch.equal(card.gather(ids.cuda()).cpu(), host.gather(ids))
