"""The hybrid family served from the state pool (zamba2-7b reduced), and the
KV kernels' head-wide block, against the reference on the CPU.

zamba2-7b's attention head is 112 wide, which 32 does not divide, so its KV
takes the whole head as one MXFP4 scale block (the reference's
``quant_block``): ``quantize_kv`` and ``dequantize_kv`` equal the
reference's bit for bit but where the reference's E8M0-nearest scale
misrounds near √2·2^k (ROADMAP C2), each such row asserted to be one.  The
model at 2 heads of 112 agrees with the reference within the hybrid's
tolerances (``tests/test_torch_hybrid.py``).  ``StatePool``'s accounting
(bytes, bits an element, occupancy, page stats, state bytes a decode step)
equals the reference ``StatePool``'s for the same config through admission
and release.  ``Engine`` on ``statepool`` with dense planes emits, token
for token, what ``dense_slots`` emits; with MXFP4 planes (the head-wide
block) its first-token log-probs stay within the chip phase's gate (max
8.0, mean 1.5) of the teacher-forced forward.  B4b's head-wide launch is
emulated CTA by CTA through a stand-in for its C entry over every (byte,
scale code) pair; the ``cuda`` case holds both head-wide kernels to their
plain versions on the card.
"""

import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import paged_cache as JP
from repro.serve.state_pool import StatePool as JStatePool
from repro.train import serve as JSV
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.core import formats as F
from repro_torch.kernels import kv_pack as KV
from repro_torch.models import build_model
from repro_torch.serve import paged_cache as TP
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.spec.config import SpecConfig
from repro_torch.serve.state_pool import StatePool
from repro_torch.train import serve as SV
from repro_torch.train.serve import cast_params

ARCH = "zamba2-7b"
HD = 112
TOKENS = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(_INT[x.dtype])


def _kv_rows(n_gauss: int = 64) -> np.ndarray:
    """Rows of 112: Gaussian rows at four scales, rows whose absmax/6 sits
    within ±8 ulps of √2·2^k (the reference's misround, C2) and a zero row."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((n_gauss, HD)) * np.repeat([1e-3, 1.0, 30.0, 1e4], n_gauss // 4)[:, None]
    edge = []
    for k in range(-12, 12):
        top = np.float32(np.sqrt(2.0) * 2.0**k * 6.0).view(np.int32) + np.arange(-8, 9)
        for t in top.astype(np.int32).view(np.float32):
            row = rng.uniform(-0.9, 0.9, HD) * t
            row[0] = t
            edge.append(row)
    return np.concatenate([g, np.asarray(edge), np.zeros((1, HD))]).astype(np.float32)


def test_quantize_kv_head_wide_matches_reference_but_c2():
    x = _kv_rows()
    jq = jax.jit(JP.quantize_kv)(jnp.asarray(x))
    tq = TP.quantize_kv(torch.from_numpy(x))
    js, ts = np.asarray(jq.scales), tq.scales.numpy()
    assert ts.shape == js.shape == (x.shape[0], 1) and tq.codes.shape == (x.shape[0], 56)
    differ = (js != ts)[:, 0]
    amax = np.abs(x).max(-1) / np.float32(6.0)
    for r in np.nonzero(differ)[0]:  # the reference misrounds near √2·2^k only
        near = np.float32(np.sqrt(2.0) * 2.0 ** np.floor(np.log2(amax[r]))).view(np.int32)
        assert abs(int(amax[r].view(np.int32)) - int(near)) <= 16, (r, amax[r])
    assert 0 < differ.sum() < 24 * 17 // 2 and not differ[:64].any()
    exact = F.scale_to_e8m0_code(torch.from_numpy(np.exp2(np.clip(np.round(np.log2(
        np.maximum(amax.astype(np.float64), 2.0 ** -126))), -126, 127)).astype(np.float32)))
    np.testing.assert_array_equal(ts[:, 0], exact.numpy())  # the port: the exact nearest power
    np.testing.assert_array_equal(tq.codes.numpy()[~differ], np.asarray(jq.codes)[~differ])
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = TP.dequantize_kv(tq.codes, tq.scales, tdt)
        want = np.asarray(JP.dequantize_kv(jq.codes, jq.scales, jdt), np.float32)
        assert got.shape == x.shape and got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy()[~differ], want[~differ])


def test_check_block_admits_the_head_wide_block_only():
    assert KV._check_block("t", 112, 1) == 112 and KV._check_block("t", 128, 4) == 32
    for k, n in ((112, 4), (80, 1), (96, 1), (100, 1)):
        with pytest.raises(ValueError, match="one scale a row"):
            KV._check_block("t", k, n)


def _pair(**over):
    jcfg = dataclasses.replace(jget_reduced(ARCH, dtype="float32"), **over)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tcfg = dataclasses.replace(get_reduced_config(ARCH, dtype="float32"), **over)
    return jm, jp, build_model(tcfg), params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _close(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1.0))


def test_head_dim_112_matches_reference():
    """2 heads of 112 (d 128): a chunk of 8 + 4 decodes over the cache tree,
    within 2e-5 of max |ref|."""
    jm, jp, tm, tp = _pair(num_heads=2, num_kv_heads=2, head_dim=HD)
    chunk = jax.jit(JSV.make_chunk_prefill_step(jm, method="bf16"))
    dec = jax.jit(JSV.make_decode_step(jm, method="bf16"))
    tchunk = SV.make_chunk_prefill_step(tm, method="bf16")
    tdec = SV.make_decode_step(tm, method="bf16")
    jc, tc = JSV.init_cache(jm, 2, 32), SV.init_cache(tm, 2, 32, "cpu")
    assert tc["attn"][0].shape == (2, 2, 32, 2, HD)
    zero = np.zeros((2,), np.int32)
    w, jc, jpos = chunk(jp, jnp.asarray(TOKENS[:, :8]), jnp.asarray(zero), jc)
    g, tc, tpos = tchunk(tp, torch.from_numpy(TOKENS[:, :8]), torch.from_numpy(zero), tc)
    _close(g.numpy(), w, 2e-5)
    for t in range(8, 12):
        w, jc, jpos = dec(jp, jnp.asarray(TOKENS[:, t:t + 1]), jpos, jc)
        g, tc, tpos = tdec(tp, torch.from_numpy(TOKENS[:, t:t + 1]), tpos, tc)
        _close(g.numpy(), w, 2e-5)


@pytest.fixture(scope="module")
def hybrid():
    cfg = get_reduced_config(ARCH)
    return build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _accounting(sp, n_tokens):
    return {"cache_bytes": sp.cache_bytes(), "bits": sp.bits_per_element(),
            "occupancy": sp.occupancy(), "stats": sp.plane_stats(),
            "step": [sp.state_bytes_per_decode_step(n) for n in n_tokens],
            "dense_step": [sp.dense_state_bytes_per_decode_step(n) for n in n_tokens]}


@pytest.mark.parametrize("kv_dtype", ["mxfp4", "dense"])
def test_state_pool_accounting_equals_reference(hybrid, kv_dtype):
    """The same admissions and releases on both pools: equal bytes, bits an
    element, occupancy, page stats and state bytes a decode step; equal
    admission answers."""
    model, _ = hybrid
    jm = jbuild(jget_reduced(ARCH))
    kw = dict(n_slots=3, max_len=40, page_size=8, kv_dtype=kv_dtype)
    jsp, tsp = JStatePool(jm, **kw), StatePool(model, device="cpu", **kw)
    assert tsp.kv.pool["k_codes" if kv_dtype == "mxfp4" else "k"].shape == \
        jsp.kv.pool["k_codes" if kv_dtype == "mxfp4" else "k"].shape
    assert [r.leaf_shape for r in tsp.rings] == [tuple(r.leaf_shape) for r in jsp.rings]
    ns = (1, 8, 9, 40, 100)
    assert _accounting(tsp, ns) == _accounting(jsp, ns)
    for slot, n in ((0, 17), (2, 40), (1, 3)):
        assert tsp.can_admit(n) == jsp.can_admit(n)
        tsp.alloc(slot, n)
        jsp.alloc(slot, n)
        assert _accounting(tsp, ns) == _accounting(jsp, ns)
        np.testing.assert_array_equal(tsp.kv.tables, jsp.kv.tables)
    assert tsp.can_admit(8) == jsp.can_admit(8)
    tsp.free(2)
    jsp.free(2)
    assert _accounting(tsp, ns) == _accounting(jsp, ns)
    tsp.check_invariants()


PROMPTS = [np.random.default_rng(3).integers(0, 512, n).astype(np.int32)
           for n in (7, 12, 5, 9, 11)]
SAMPLING = [None, SamplingParams(temperature=0.9, top_k=8, seed=11), None,
            SamplingParams(temperature=1.3, top_p=0.9, seed=5), None]


def _run(model, params, backend, kv_dtype="dense", keep_logits=False):
    eng = Engine(model, params, EngineConfig(
        n_slots=3, max_len=32, page_size=8, kv_dtype=kv_dtype, prefill_chunk=8,
        decode_backend=backend, debug_cache=True, keep_logits=keep_logits))
    hs = [eng.submit(p, 4, sampling=s) for p, s in zip(PROMPTS, SAMPLING)]
    eng.drain()
    return eng, hs


def test_statepool_dense_matches_dense_slots(hybrid):
    """Greedy and sampled requests, 5 requests on 3 slots: retired KV pages
    and rings are reused and must not leak into a later request."""
    model, params = hybrid
    eng, pooled = _run(model, params, "statepool")
    assert eng.decode_backend == "statepool" and eng.cache.kv is not None
    assert eng.cache.kv.free_pages == eng.cache.kv.n_pages - 1  # every page back
    _, oracle = _run(model, params, "dense_slots")
    assert [h.tokens for h in pooled] == [h.tokens for h in oracle]
    assert all(len(h.tokens) == 4 for h in pooled)


def test_mxfp4_planes_against_teacher_forced():
    """The default backend at head dim 112 (2 heads): the KV plane holds the
    head-wide block; each request's first-token log-probs within the gate
    (max 8.0, mean 1.5) of the teacher-forced forward of its prompt."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), num_heads=2, num_kv_heads=2, head_dim=HD)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng, hs = _run(model, params, None, kv_dtype="mxfp4", keep_logits=True)
    assert eng.cache.kv.pool["k_scales"].shape[-1] == 1  # one scale a head
    assert eng.cache.kv.pool["k_scales"].any()
    cp = cast_params(params, torch.bfloat16)
    for p, h in zip(PROMPTS, hs):
        with torch.inference_mode():
            feats, _ = model.forward(cp, torch.from_numpy(p)[None], 0, features_only=True)
            ref = torch.log_softmax(model.head(cp, feats[:, -1:], 0)[0, 0].float(), -1)
        d = (torch.log_softmax(torch.as_tensor(h.logits_trace[0]).float(), -1) - ref).abs()
        assert float(d.max()) < 8.0 and float(d.mean()) < 1.5


def test_gates_for_the_hybrid_family(hybrid):
    model, params = hybrid
    with pytest.raises(ValueError, match="one token per state"):
        Engine(model, params, EngineConfig(spec=SpecConfig(k=2)))
    with pytest.raises(ValueError, match="prefix caching"):
        Engine(model, params, EngineConfig(prefix_cache=True))
    with pytest.raises(ValueError, match="statepool"):
        Engine(model, params, EngineConfig(decode_backend="paged"))


def _every_pair_rows(n_rows: int, shift: int):
    """Head-wide codes [n_rows, 56] and scales [n_rows, 1] holding every
    (byte, scale code) pair: flat byte f is (f + 16·shift) mod 256, row r's
    scale (r // 32 + shift) mod 256."""
    codes = ((torch.arange(n_rows * 56) + 16 * shift) % 256).to(torch.uint8)
    scales = ((torch.arange(n_rows) // 32 + shift) % 256).to(torch.uint8)
    return codes.reshape(n_rows, 56), scales.reshape(n_rows, 1)


def _row_arithmetic(codes: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """codes [R, 56] u8 (one head-wide row each), scales [R] u8 → [R, 112]
    as the kernel computes them: the 16 signed E2M1 values (its
    ``e2m1_value``) times 2^(code − 127) from the bits, one f32 multiply."""
    nib = torch.arange(16, dtype=torch.int32)
    i = nib & 7
    pw = ((((i - 2).clamp(min=0)) >> 1) + 127 << 23).view(torch.float32)
    lut = torch.where(i >= 2, pw * (1.0 + 0.5 * (i & 1).float()), 0.5 * i.float())
    lut = torch.where((nib & 8) > 0, -lut, lut)
    n = torch.stack([codes >> 4, codes & 0xF], -1).reshape(codes.shape[0], HD).long()
    return (lut[n] * (scales.to(torch.int32) << 23).view(torch.float32)[:, None]).to(dtype)


class _EmulatedRowsLaunch:
    """Stands in for the C entry ``kv_gather_dequant_rows``: walks the
    head-wide kernel's grid, CTA by CTA (tiles of whole rows), over the raw
    memory behind the pointers."""

    def __init__(self):
        self.calls = []

    def __call__(self, n_src, codes, scales, out, tables, n_out_chunks, chunk, total, n_tbl,
                 n_pages, row_bytes, out_bf16, stream):
        assert row_bytes == HD // 2 and chunk % row_bytes == 0 and total % row_bytes == 0
        dtype = torch.bfloat16 if out_bf16 else torch.float32
        tile = KV.tile_bytes(HD)
        tiles = -(-chunk // tile)
        self.calls.append(dict(grid=(n_out_chunks * tiles, n_src), chunk=chunk, total=total))
        for y in range(n_src):
            for x in range(n_out_chunks * tiles):
                c, t = divmod(x, tiles)
                out_base = c * chunk + t * tile
                left = total - out_base
                if left <= 0:
                    continue
                n = min(tile, chunk - t * tile, left)
                src = c
                if tables:
                    page = ctypes.c_int32.from_address(tables + 4 * (c % n_tbl)).value
                    src = (c // n_tbl) * n_pages + page
                in_base = src * chunk + t * tile
                cb = torch.frombuffer(bytearray(ctypes.string_at(codes[y] + in_base, n)),
                                      dtype=torch.uint8)
                sb = torch.frombuffer(bytearray(ctypes.string_at(
                    scales[y] + in_base // row_bytes, n // row_bytes)), dtype=torch.uint8)
                vals = _row_arithmetic(cb.reshape(-1, row_bytes), sb, dtype).contiguous()
                ctypes.memmove(out[y] + 2 * out_base * vals.element_size(), vals.data_ptr(),
                               vals.numel() * vals.element_size())
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["k+v gather", "2-d", "2-d short last chunk"])
def test_head_wide_launch_emulated_on_the_host_equals_plain(monkeypatch, form, dtype):
    """The wrappers' head-wide launches, their C entry emulated CTA by CTA:
    one launch each, equal to the plain version by bit pattern over every
    (byte, scale code) pair; a page of 32 heads (28672 code bytes) spans
    four tiles of 146 rows, the last one short."""
    fake = _EmulatedRowsLaunch()
    monkeypatch.setattr(KV, "_device", lambda name, t: True)
    monkeypatch.setattr(KV, "_entries", lambda: (None, None, None, fake))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    before = KV.kv_dequant_unpack.launches
    if form == "k+v gather":
        L, n_pages, ps, H = 2, 5, 16, 32
        n = L * n_pages * ps * H
        kc, ks = _every_pair_rows(n, 0)
        vc, vs = _every_pair_rows(n, 97)
        shape = (L, n_pages, ps, H)
        leaves = [kc.reshape(*shape, 56), ks.reshape(*shape, 1), vc.reshape(*shape, 56),
                  vs.reshape(*shape, 1)]
        tables = torch.tensor([[3, 1], [4, 0], [2, 3]], dtype=torch.int32)
        got = KV.kv_gather_dequant_kv(*leaves, tables, dtype)
        idx = tables.long()
        want = [KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], dtype).reshape(g.shape)
                for (c, s), g in zip(((leaves[0], leaves[1]), (leaves[2], leaves[3])), got)]
        assert fake.calls[-1]["chunk"] == ps * H * 56 and fake.calls[-1]["grid"] == (48, 2)
    else:
        m = 8192 if form == "2-d" else 8192 - 37
        codes, scales = _every_pair_rows(m, 5)
        got = [KV.kv_dequant_unpack(codes, scales, dtype)]
        want = [KV.kv_dequant_unpack_plain(codes, scales, dtype)]
        assert fake.calls[-1]["chunk"] == KV.tile_bytes(HD) == 146 * 56
    assert KV.kv_dequant_unpack.launches - before == 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_head_wide_b4a_b4b_on_card():
    """B4a and B4b with the head-wide block on the card against their plain
    versions run there, bit for bit: the K+V scatter (strided rows and rows
    no 16-byte load reads), the 2-d quantize over the C2 edge rows, the K+V
    gather and the 2-d dequantize over every (byte, scale code) pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = "cuda"
    x = torch.from_numpy(_kv_rows()).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        c, s = KV.kv_quant_pack(x.to(dt), HD)
        pc, ps_ = KV.kv_quant_pack_plain(x.to(dt), HD)
        assert torch.equal(c, pc) and torch.equal(s, ps_)
    L, n_pages, ps, H = 2, 9, 8, 4
    rng = np.random.default_rng(2)
    for width in (HD, HD + 1):
        base = torch.from_numpy(rng.standard_normal((L, 6, H, width)).astype(np.float32))
        base = base.to(dev, torch.bfloat16)
        k, v = base[:, ::2, :, :HD], base[:, 1::2, :, :HD]
        pid = torch.tensor([3, 1, 7], dtype=torch.int32, device=dev)
        off = torch.tensor([0, 5, 7], dtype=torch.int32, device=dev)
        shape = (L, n_pages, ps, H)
        got = [torch.zeros((*shape, w), dtype=torch.uint8, device=dev) for w in (56, 1, 56, 1)]
        want = [t.clone() for t in got]
        KV.kv_quant_scatter_kv(*got, pid, off, k, v)
        for (c, s), src in (((want[0], want[1]), k), ((want[2], want[3]), v)):
            qc, qs = KV.kv_quant_pack_plain(src.reshape(-1, HD), HD)
            c[:, pid.long(), off.long()] = qc.reshape(L, 3, H, 56)
            s[:, pid.long(), off.long()] = qs.reshape(L, 3, H, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), width
    kc, ks = (t.to(dev) for t in _every_pair_rows(L * n_pages * ps * H, 0))
    kc, ks = kc.reshape(L, n_pages, ps, H, 56), ks.reshape(L, n_pages, ps, H, 1)
    tables = torch.tensor([[3, 1, 0], [8, 2, 3]], dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        gk, gv = KV.kv_gather_dequant_kv(kc, ks, kc, ks, tables, dt)
        want = KV.kv_dequant_unpack_plain(kc[:, tables.long()], ks[:, tables.long()], dt)
        assert torch.equal(_bits(gk), _bits(want.reshape(gk.shape)))
        assert torch.equal(_bits(gv), _bits(gk))
        for m in (8192, 8192 - 37):
            c, s = (t.to(dev) for t in _every_pair_rows(m, 5))
            assert torch.equal(_bits(KV.kv_dequant_unpack(c, s, dt)),
                               _bits(KV.kv_dequant_unpack_plain(c, s, dt)))
    torch.cuda.synchronize()
