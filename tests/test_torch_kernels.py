"""PyTorch port vs the JAX reference: the serving, training and evaluation kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that plain version against the reference's Pallas kernel, run in
interpret mode as tests/test_kernels.py and tests/test_paged_attention.py
run it.  The kernels themselves run only on the card: the ``cuda`` test
below checks each against its plain version there and skips here.

Tolerances: Stage-1 quantization, forward and backward, is bit-exact (the
plain versions' butterfly Hadamard and halving sums land on the reference's
bits on these sweeps; the backward's uniforms are the same counter hash);
the GEMM takes the reference test's rtol 1e-6 / atol 1e-5 (exact
per-group integer products, f32 sums in another order); attention takes
atol 1e-5 in f32 (online vs full softmax, another summation order), flash
attention the reference test's rtol = atol = 1e-5.  KV quantize-pack and
unpack-dequantize are bit-exact, except that near √2·2^k the reference's
float ``log2`` can misround an E8M0 scale (ROADMAP C2): there every
disagreement must be such a misround.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quartet import QuartetConfig as JQuartetConfig
from repro.core.quartet import quartet_linear as jquartet_linear
from repro.core import fastrng as JR
from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import mha_flash as jmha_flash
from repro.kernels import ref as JREF
from repro.kernels.hadamard_quant import hadamard_quest_quantize as jhq
from repro.kernels.mxfp4_matmul import mxfp4_matmul as jmm
from repro.kernels.sr_hadamard_quant import sr_hadamard_quantize as jsr
from repro_torch.core import formats as F
from repro_torch.core.hadamard import hadamard_transform
from repro_torch.core.quartet import QuartetConfig, quartet_linear
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import kv_pack as KV
from repro_torch.kernels import sr_hadamard_quant as SR
from repro_torch.kernels import mxfp4_matmul as MM
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA

# jit the reference's pool writes: eager mode compiles every op per shape
_jscatter = jax.jit(JPA.scatter_token)

SHAPES = [(32, 32), (8, 64), (96, 256), (128, 96), (257, 64), (64, 1024)]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hadamard_quest_plain_bit_exact_vs_reference(shape, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * 1.9).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jhq(xj, block_m=64, block_k=128)
    got = HQ.hadamard_quest_quantize(xt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    # the transposed weight view is read in place, with the same result
    got_t = HQ.hadamard_quest_quantize(torch.from_numpy(np.ascontiguousarray(x.T)).t())
    for g, w in zip(got_t, HQ.hadamard_quest_quantize_plain(torch.from_numpy(x))):
        assert torch.equal(g, w)


def test_hadamard_quest_reciprocal_scale_bit_exact():
    """The vector body divides by the E8M0 scale 2^e as a multiply by 2^-e
    built from the bits (2^-127 as a subnormal) and by the RTN's binade as a
    multiply by its reciprocal: for every e in [-126, 127] and values whose
    quotients span the normal and subnormal range, the bits equal the
    division's."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(4096) * np.exp2(rng.uniform(-40, 40, 4096)))
                         .astype(np.float32))
    v = torch.cat([v, torch.tensor([0.0, -0.0, 1e-38, -3e-39, 6.0, 3.4e38])])
    for e in range(-126, 128):
        scale = F.exp2i(torch.tensor(e))
        inv = (torch.tensor((127 - e) << 23, dtype=torch.int32).view(torch.float32) if e < 127
               else torch.tensor(0x00400000, dtype=torch.int32).view(torch.float32))
        assert float(inv) * 2.0 ** e == 1.0
        assert torch.equal((v * inv).view(torch.int32), (v / scale).view(torch.int32))
    a = torch.linspace(1.0, 6.0, 2001)
    for pw in (1.0, 2.0, 4.0):
        assert torch.equal(a / pw, a * (1.0 / pw))


def test_hadamard_quest_half_code_arithmetic_bit_exact():
    """The vector body's half-code, rint(|q|·2/pw)·pw with q's sign (pw = 1,
    2, 4 by binade of min(|q|, 6)), equals the plain version's
    round(2·RTN_E2M1(clip(q, ±6))) at every tie, binade edge and beyond."""
    grid = torch.linspace(-7.5, 7.5, 600001)
    ties = torch.tensor([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 1.0, 2.0, 4.0, 6.0, 1e-40, 0.0])
    q = torch.cat([grid, ties, -ties, torch.nextafter(ties, torch.full_like(ties, 9.0)),
                   torch.nextafter(ties, torch.zeros_like(ties))])
    a = torch.clamp(q.abs(), max=6.0)
    s = torch.where(a >= 4, 0.5, torch.where(a >= 2, 1.0, 2.0))
    pw = torch.where(a >= 4, 4.0, torch.where(a >= 2, 2.0, 1.0))
    mag = (torch.round(a * s) * pw).to(torch.int32)
    got = torch.where(q < 0, -mag, mag).to(torch.int8)
    want = torch.round(F.rtn_e2m1(torch.clamp(q, -6.0, 6.0)) * 2.0).to(torch.int8)
    assert torch.equal(got, want)


def test_hadamard_quest_vector_body_taken_at_every_call_site():
    """Activations (row-major) and every Wᵀ view of the serving and training
    linears take the vector body; views that 16-byte runs cannot read do not."""
    for dt in (torch.bfloat16, torch.float32):
        for K, N in ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048),
                     (1280, 3456), (3456, 1280), (32, 64)):
            w = torch.zeros((K, N), dtype=dt)
            assert HQ.vector_ok(w.t()) and HQ.vector_ok(torch.zeros((8, K), dtype=dt))
            assert HQ.vector_ok(torch.zeros((1, K), dtype=dt))
        base = torch.zeros((64, 1000), dtype=dt)
        assert HQ.vector_ok(base[:, :992].t())  # 992 rows of Wᵀ: M % 8 == 0
        assert not HQ.vector_ok(base[:, 1:993].t())  # base off 16 bytes
        assert not HQ.vector_ok(base[:, 3:3 + 224])
        assert HQ.vector_ok(torch.zeros((36, 64), dtype=dt)[:, :32].t())  # M = 32 of Wᵀ
        assert not HQ.vector_ok(torch.zeros((64, 36), dtype=dt).t()[:, :32])  # M % 8 != 0
        assert not HQ.vector_ok(torch.zeros((64, 64), dtype=dt)[::2, ::2][:, :32])


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (64, 128, 96), (100, 64, 50),
                                   (8, 512, 128)])
def test_mxfp4_matmul_plain_vs_reference(m, k, n):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 1.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.5).astype(np.float32))
    ac, asc, _ = HQ.hadamard_quest_quantize(x)
    bct, bsct, _ = HQ.hadamard_quest_quantize(w.t())
    got = MM.mxfp4_matmul(ac, asc, bct.t(), bsct.t())
    want = jmm(jnp.asarray(ac.numpy()), jnp.asarray(asc.numpy()),
               jnp.asarray(bct.numpy()).T, jnp.asarray(bsct.numpy()).T,
               block_m=64, block_n=64, block_k=128)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-5)


# the card's B3 design, emulated in PyTorch: each operand dequantized to
# bf16 with its scale folded in, each 32-group's product in f32 from those
# bf16 values, the group terms added in group order
_E2M1_HALF_CODES = np.array([0, 1, 2, 3, 4, 6, 8, 12], np.int8)


def _b3_operands(m, k, n, seed, binades=40):
    rng = np.random.default_rng(seed)

    def codes(shape):
        return _E2M1_HALF_CODES[rng.integers(0, 8, shape)] * rng.choice(
            np.array([-1, 1], np.int8), shape)

    def scales(shape):
        e = rng.integers(-binades, binades + 1, shape)
        return np.ldexp(np.float32(1), e).astype(np.float32)

    a, sa = codes((m, k)), scales((m, k // 32))
    bt, sbt = codes((n, k)), scales((n, k // 32))  # B as the call sites hold it: [N, K]
    return (torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(bt).t(),
            torch.from_numpy(sbt).t())


def _b3_tensor_core_emulation(a_codes, a_scales, b_codes, b_scales):
    m, k = a_codes.shape
    n = b_codes.shape[1]
    af = a_codes.float().reshape(m, k // 32, 32) * (0.5 * a_scales)[..., None]
    bf = b_codes.float().reshape(k // 32, 32, n) * (0.5 * b_scales)[:, None, :]
    a16, b16 = af.to(torch.bfloat16), bf.to(torch.bfloat16)
    # the fold is exact: at most 2 significant bits times a power of two
    assert torch.equal(a16.float(), af) and torch.equal(b16.float(), bf)
    acc = torch.zeros((m, n), dtype=torch.float32)
    for g in range(k // 32):
        acc = acc + a16[:, g].float() @ b16[g].float()
    return acc


@pytest.mark.parametrize("m,k,n", [(8, 2048, 1024), (100, 96, 50), (64, 256, 3456)])
def test_mxfp4_matmul_tensor_core_arithmetic_is_bit_exact(m, k, n):
    """Scale codes swept over ±40 binades: the folded bf16 products and the
    group-order f32 sum land on the plain version's bits."""
    args = _b3_operands(m, k, n, seed=m + k + n)
    assert torch.equal(_b3_tensor_core_emulation(*args), MM.mxfp4_matmul_plain(*args))


def test_mxfp4_matmul_int8_to_bf16_byte_arithmetic():
    """The kernel's int8 → bf16 step for every code in [-64, 63]: per byte
    (c ^ 0x80) - 64 = c + 64, the bf16 0x43·· with that mantissa is c + 192,
    and c + 192 minus 192, times a power of two, is c·s exactly (one
    rounding, as the bf16x2 FMA)."""
    c = np.arange(-64, 64, dtype=np.int8)
    t = ((c.view(np.uint8) ^ 0x80).astype(np.int32) - 0x40).astype(np.uint16)
    assert t.min() >= 0 and t.max() <= 0x7F  # no borrow into the next byte
    v = torch.from_numpy((0x4300 | t).view(np.int16)).view(torch.bfloat16).float()
    assert torch.equal(v, torch.from_numpy(c.astype(np.float32)) + 192)
    for e in (-60, -1, 0, 50):
        s = 2.0**e
        folded = (v.double() * s - 192 * s).to(torch.bfloat16)
        assert torch.equal(folded.double(), torch.from_numpy(c.astype(np.float64)) * s)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_quartet_linear_forward_vs_reference(use_kernels):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    jcfg = JQuartetConfig(use_kernels=use_kernels)
    want = jax.jit(lambda a, b: jquartet_linear(a, b, jnp.uint32(5), jcfg))(
        jnp.asarray(x), jnp.asarray(w))
    got = quartet_linear(torch.from_numpy(x), torch.from_numpy(w), 5,
                         QuartetConfig(use_kernels=use_kernels))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    # with inputs that require grad the forward is the same (the backward is
    # held against the reference in tests/test_torch_train.py)
    got_g = quartet_linear(torch.from_numpy(x).requires_grad_(), torch.from_numpy(w), 5,
                           QuartetConfig(use_kernels=use_kernels))
    assert got_g.requires_grad and torch.equal(got_g.detach(), got)


# ---------------------------------------------------------------------------
# backward Stage 1: randomized Hadamard + stochastic rounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_sr_hadamard_plain_bit_exact_vs_reference(shape):
    """Codes and scales equal the reference's Pallas kernel (interpret mode,
    fed the same counter-hash uniforms) and its jnp oracle; a transposed
    view hashes its logical index, so it gives the same bits as the
    contiguous operand."""
    seed, salt = 5, 3
    x = (np.random.default_rng(2).standard_normal(shape) * 2.3).astype(np.float32)
    signs = np.asarray(JR.rademacher(jnp.uint32(9), shape[1]))
    u = jax.jit(lambda s: JR.uniform(s, shape, salt))(jnp.uint32(seed))
    want = jsr(jnp.asarray(x), jnp.asarray(signs), u, block_m=64, block_k=128)
    oracle = jax.jit(JREF.sr_hadamard_quantize_ref)(jnp.asarray(x), jnp.asarray(signs), u)
    got = SR.sr_hadamard_quantize(torch.from_numpy(x), torch.from_numpy(signs), seed,
                                  salt=salt)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g.numpy(), _np(w))
        np.testing.assert_array_equal(g.numpy(), _np(o))
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    for g, w in zip(SR.sr_hadamard_quantize(xt, torch.from_numpy(signs), seed, salt=salt), got):
        assert torch.equal(g, w)


def test_sr_hadamard_plain_unbiased():
    """E[dequant(SR(x·H))] = x·H: n copies of the same 4 rows draw
    independent uniforms (each element hashes its own index), and their
    mean lands within the reference test's ≈5σ bound for n = 3000."""
    n = 3000
    x = (np.random.default_rng(3).standard_normal((4, 32)) * 1.1).astype(np.float32)
    xt = torch.from_numpy(np.tile(x, (n, 1)))
    codes, scales = SR.sr_hadamard_quantize(xt, torch.ones(32), 0, prescale=1.0)
    vals = (codes.float() * 0.5 * scales).reshape(n, 4, 32)
    target = hadamard_transform(torch.from_numpy(x), g=32)
    assert float((vals.mean(0) - target).abs().max()) < 0.08


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _pools(mode, written, ps, Hkv, hd, n_pp, seed):
    """The same random KV written through both packages' scatter (one call
    for all slots' tokens), returning (jax pool, torch pool, tables)."""
    rng = np.random.default_rng(seed)
    B = len(written)
    n_pages = 1 + B * n_pp
    tables = np.zeros((B, n_pp), np.int32)
    nxt = 1
    for b in range(B):
        for p in range(-(-written[b] // ps)):
            tables[b, p] = nxt
            nxt += 1
    if mode == "dense":
        jpool = {n: jnp.zeros((n_pages, ps, Hkv, hd), jnp.float32) for n in ("k", "v")}
    else:
        nb = hd // PA.quant_block(hd)
        shapes = {"k_codes": hd // 2, "k_scales": nb, "v_codes": hd // 2, "v_scales": nb}
        jpool = {n: jnp.zeros((n_pages, ps, Hkv, w), jnp.uint8) for n, w in shapes.items()}
    tpool = {n: torch.from_numpy(np.asarray(a).copy()) for n, a in jpool.items()}
    pos = [(b, t) for b, n in enumerate(written) for t in range(n)]
    pid = np.array([tables[b, t // ps] for b, t in pos], np.int32)
    off = np.array([t % ps for _, t in pos], np.int32)
    k = (rng.standard_normal((len(pos), Hkv, hd)) * 1.5).astype(np.float32)
    v = (rng.standard_normal((len(pos), Hkv, hd)) * 1.5).astype(np.float32)
    jpool = _jscatter(jpool, jnp.asarray(pid), jnp.asarray(off), jnp.asarray(k),
                      jnp.asarray(v))
    PA.scatter_token(tpool, torch.from_numpy(pid), torch.from_numpy(off),
                     torch.from_numpy(k), torch.from_numpy(v))
    for name in jpool:  # quantize-on-write is bit-exact
        np.testing.assert_array_equal(tpool[name].numpy(), _np(jpool[name]))
    return jpool, tpool, tables


def _both(q, jpool, tpool, tables, lengths):
    want = JPA.paged_attention(jnp.asarray(q), jpool, jnp.asarray(tables),
                               jnp.asarray(lengths, jnp.int32))
    got = PA.paged_attention(torch.from_numpy(q), tpool, torch.from_numpy(tables),
                             torch.tensor(lengths, dtype=torch.int32))
    return got.numpy(), _np(want)


@pytest.mark.parametrize("mode,ps,group", [("dense", 4, 1), ("dense", 8, 2), ("dense", 16, 4),
                                           ("mxfp4", 4, 2), ("mxfp4", 16, 1)])
def test_paged_attention_decode_vs_reference(mode, ps, group):
    lengths = [7, 1, 2 * ps, ps + 3]  # ragged, a single token, page-exact
    Hkv, hd = 2, 32
    n_pp = max(-(-max(lengths) // ps), 2)
    jpool, tpool, tables = _pools(mode, lengths, ps, Hkv, hd, n_pp, seed=ps + group)
    q = np.random.default_rng(9).standard_normal((4, Hkv * group, hd)).astype(np.float32)
    got, want = _both(q, jpool, tpool, tables, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "mxfp4"])
def test_paged_attention_multi_query_vs_reference(mode):
    """S tokens per slot, row s bounded at lengths[b] − 1 + s; unmapped
    table entries point at a poisoned scratch page that must not leak."""
    ps, Hkv, group, hd, S = 4, 2, 2, 32, 5
    lengths = [6, 1, 9]
    n_pp = -(-(max(lengths) + S - 1) // ps) + 1
    jpool, tpool, tables = _pools(mode, [n + S - 1 for n in lengths], ps, Hkv, hd,
                                  n_pp, seed=7)
    if mode == "dense":
        tpool["k"][0] = 1e3
        tpool["v"][0] = 1e3
        jpool = {n: jnp.asarray(t.numpy()) for n, t in tpool.items()}
    q = np.random.default_rng(77).standard_normal((3, S, Hkv * group, hd)).astype(np.float32)
    got, want = _both(q, jpool, tpool, tables, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() < 100.0  # the poisoned scratch page never reached a row


def test_prefill_chunk_layout_matches_reference():
    ps, C = 4, 5
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    mask = np.array([True, True, False])
    start = np.array([4, 0, 2], np.int32)
    n_valid = np.array([5, 2, 3], np.int32)
    jt, jp = JPA.prefill_chunk_layout(jnp.asarray(tables), jnp.asarray(start),
                                      jnp.asarray(n_valid), C, ps, jnp.asarray(mask))
    tt, tp = PA.prefill_chunk_layout(torch.from_numpy(tables), torch.from_numpy(start),
                                     torch.from_numpy(n_valid), C, ps,
                                     torch.from_numpy(mask))
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(tp[1].numpy(), [0, 1, 12, 12, 12])  # sentinel column


@pytest.mark.parametrize("mode", ["dense", "mxfp4"])
def test_paged_attention_batched_prefill_vs_reference(mode):
    """A [B, C] chunk at per-slot starts with ragged valid counts, written
    through the sentinel layout (padding to scratch page 0) by both
    packages, then attended: valid rows agree; pools agree bit for bit."""
    ps, Hkv, group, hd, C = 4, 2, 2, 32, 6
    starts, n_valid = [4, 0, 9], [6, 3, 1]
    B = len(starts)
    n_pp = -(-max(s + n for s, n in zip(starts, n_valid)) // ps) + 1
    jpool, tpool, tables = _pools(mode, [s + n for s, n in zip(starts, n_valid)], ps,
                                  Hkv, hd, n_pp, seed=21)
    rng = np.random.default_rng(22)
    ck = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    mask = np.ones(B, bool)
    st, nv = np.asarray(starts, np.int32), np.asarray(n_valid, np.int32)
    jt, jp = JPA.prefill_chunk_layout(jnp.asarray(tables), jnp.asarray(st), jnp.asarray(nv),
                                      C, ps, jnp.asarray(mask))
    jpid = jt[jnp.arange(B)[:, None], jp // ps]
    jpool = _jscatter(jpool, jpid, jp % ps, jnp.asarray(ck), jnp.asarray(cv))
    tt, tp = PA.prefill_chunk_layout(torch.from_numpy(tables), torch.from_numpy(st),
                                     torch.from_numpy(nv), C, ps, torch.from_numpy(mask))
    tpid = tt[torch.arange(B)[:, None], (tp // ps).long()]
    PA.scatter_token(tpool, tpid, tp % ps, torch.from_numpy(ck), torch.from_numpy(cv))
    for name in jpool:
        np.testing.assert_array_equal(tpool[name][1:].numpy(), _np(jpool[name])[1:])
    q = rng.standard_normal((B, C, Hkv * group, hd)).astype(np.float32)
    got, want = _both(q, jpool, tpool, np.asarray(tt),
                      [s + 1 for s in starts])
    for b in range(B):  # padding rows are garbage by design
        np.testing.assert_allclose(got[b, :n_valid[b]], want[b, :n_valid[b]],
                                   rtol=0, atol=1e-5)


def _b5_split_emulation(q, pool, tables, lengths, tensor_core=True):
    """The card's split B5 design in PyTorch.  Positions cut into chunks of
    ``blocks`` sub-blocks of 64 keys and each sub-block into ``KEY_PARTS``
    key parts (``PA.split_plan``).  Per chunk, part and row, over the chunk's
    sub-blocks in order, an online softmax: m = max of the visible scores so
    far (-1e30 before any), corr = 2^(m_old·c − m·c), p = 2^(s·c − m·c) (0
    where masked: past the row's bound or on a page at or past n_visit), l
    = l·corr + Σp, acc = acc·corr + P·V; a chunk past n_visit (except chunk
    0) writes nothing.  A chunk's four parts merge per row: M = max m·c over
    parts with l > 0, w = 2^(m·c − M), L = Σ l·w in part order, acc = (w0·a0
    + w1·a1) + (w2·a2 + w3·a3).  The chunks merge in chunk order the same
    way: M = max over chunks with L > 0, w = 2^(M_chunk − M), out = Σ w·acc
    / max(Σ L·w, 1e-30).  ``tensor_core``: K and V rounded to bf16 (exact
    for the pool's values), scores unscaled from the bf16 queries in f32, c
    = scale·log2 e; P split into bf16 hi + lo for P·V.  Otherwise all f32,
    scores scaled first."""
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, S, Hq, hd = q4.shape
    k, v = PA._gather_kv(pool, tables)  # f32 [B, n_pp·ps, Hkv, hd]
    Hkv = k.shape[2]
    ps = next(iter(pool.values())).shape[1]
    n_pp = tables.shape[1]
    if tensor_core:
        assert torch.equal(k.to(torch.bfloat16).float(), k)  # dequantized K/V are bf16-exact
        assert torch.equal(v.to(torch.bfloat16).float(), v)
    plan = PA.split_plan(S, Hq, Hkv, ps, n_pp)
    group, R = Hq // Hkv, S * (Hq // Hkv)
    chunk_keys = plan.blocks * PA.CHUNK_KEYS
    pad = plan.n_chunks * chunk_keys - k.shape[1]
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qr = q4.float().reshape(B, S, Hkv, group, hd).transpose(1, 2).reshape(B, Hkv, R, hd)
    if tensor_core:
        s_all = torch.einsum("bhrd,bthd->bhrt", qr, k)  # unscaled
        c = scale * 1.4426950408889634
    else:
        s_all = torch.einsum("bhrd,bthd->bhrt", qr * scale, k)
        c = 1.4426950408889634
    lens = lengths.long()
    q_pos = lens[:, None] - 1 + torch.arange(R)[None, :] // group  # [B, R]
    kv_end = torch.clamp((lens + S - 1 + ps - 1) // ps, max=n_pp) * ps
    n_cta = torch.clamp((kv_end + chunk_keys - 1) // chunk_keys, min=1)
    kpos = torch.arange(plan.n_chunks * chunk_keys)
    vis = (kpos[None, None, :] <= q_pos[:, :, None]) & (kpos[None, None, :] < kv_end[:, None, None])
    vis = vis[:, None].expand(B, Hkv, R, -1)  # [B, Hkv, R, T]
    nk = PA.CHUNK_KEYS // PA.KEY_PARTS
    neg = PA.NEG_INF
    parts = []
    for chunk in range(plan.n_chunks):
        own = []
        for part in range(PA.KEY_PARTS):
            m = torch.full((B, Hkv, R), neg)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, Hkv, R, hd))
            for j in range(plan.blocks):
                k0 = chunk * chunk_keys + j * PA.CHUNK_KEYS + part * nk
                sc, vv = s_all[..., k0:k0 + nk], vis[..., k0:k0 + nk]
                m_new = torch.maximum(m, torch.where(vv, sc, torch.full_like(sc, neg)).amax(-1))
                corr = torch.exp2((m - m_new) * c)
                p = torch.where(vv, torch.exp2(sc * c - (m_new * c)[..., None]),
                                torch.zeros_like(sc))
                vb = v[:, k0:k0 + nk].transpose(1, 2)  # [B, Hkv, nk, hd]
                if tensor_core:
                    hi = p.to(torch.bfloat16).float()
                    lo = (p - hi).to(torch.bfloat16).float()
                    pv = hi @ vb + lo @ vb
                else:
                    pv = p @ vb
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + pv
                m = m_new
            own.append((torch.where(l > 0, m * c, torch.full_like(m, neg)), l, acc))
        # the CTA's merge of its four parts, per row
        Mc = torch.full_like(own[0][1], neg)
        for mc, l, _ in own:
            Mc = torch.where(l > 0, torch.maximum(Mc, mc), Mc)
        w = [torch.where(l > 0, torch.exp2(mc - Mc), torch.zeros_like(Mc)) for mc, l, _ in own]
        Lc = torch.zeros_like(Mc)
        for (_, l, _), wp in zip(own, w):
            Lc = Lc + l * wp
        a = [wp[..., None] * acc for (_, _, acc), wp in zip(own, w)]
        acc = (a[0] + a[1]) + (a[2] + a[3])
        used = (chunk < n_cta)[:, None, None]  # [B, 1, 1]
        Lc = torch.where(used, Lc, torch.zeros_like(Lc))
        parts.append((Mc, Lc, acc))
    M = torch.full_like(parts[0][1], -torch.inf)
    for mc, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, mc), M)
    L = torch.zeros_like(M)
    out = torch.zeros_like(parts[0][2])
    for mc, l, acc in parts:  # in chunk order
        w = torch.where(l > 0, torch.exp2(mc - M), torch.zeros_like(M))
        L = L + l * w
        out = out + w[..., None] * torch.where((l > 0)[..., None], acc, torch.zeros_like(acc))
    out = out / torch.clamp(L, min=1e-30)[..., None]
    out = out.reshape(B, Hkv, S, group, hd).transpose(1, 2).reshape(B, S, Hq, hd).to(q.dtype)
    return out if multi else out[:, 0]


# (pool, ps, group, S, hd, lengths, n_pp): one visible key, page multiples
# (16, 32), rows past a full table (clamped at n_pp), chunks of a wide table
# with no visible key, one and several query tiles (R = 24: a partial
# second tile), several chunks of several sub-blocks,
# and tables wide enough that the chunk cap adds sub-blocks: a decode over
# 32768 positions (qwen3-1.7b's published context; 16 sub-blocks a CTA) and
# a multi-query call over 8800 (5 a CTA)
B5_SPLIT_CASES = [("mxfp4", 16, 2, 1, 128, [1, 16, 32, 100], 8),
                  ("mxfp4", 16, 2, 64, 128, [1, 16, 40, 70], 8),
                  ("dense", 16, 2, 12, 128, [1, 16, 33, 250], 20),
                  ("mxfp4", 8, 4, 3, 64, [5, 8, 64, 24], 12),
                  ("dense", 32, 2, 1, 64, [1, 32, 64, 200], 8),
                  ("mxfp4", 8, 2, 20, 64, [300, 5, 520, 64], 72),
                  ("mxfp4", 16, 2, 1, 64, [1, 700, 32768, 9000], 2048),
                  ("dense", 8, 2, 20, 64, [9000, 1, 8781, 300], 1100)]


@pytest.mark.parametrize("mode,ps,group,S,hd,lens,n_pp", B5_SPLIT_CASES)
def test_paged_attention_split_arithmetic_within_bf16_check(mode, ps, group, S, hd, lens, n_pp):
    """The card's bf16 B5 arithmetic against the plain version, held to the
    card check's bf16 tolerance, |Δ| <= 1e-5 + 2^-7·|plain|."""
    Hkv = 2
    written = [min(n + S - 1, n_pp * ps) for n in lens]
    _, pool, tables = _pools(mode, written, ps, Hkv, hd, n_pp, seed=ps + S)
    pool = {n: t.to(torch.bfloat16) if mode == "dense" else t for n, t in pool.items()}
    tables = torch.from_numpy(tables)
    rng = np.random.default_rng(S + hd)
    q = torch.from_numpy(rng.standard_normal((len(lens), S, Hkv * group, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32)
    got = _b5_split_emulation(q, pool, tables, ln).float()
    want = PA.paged_attention_plain(q, pool, tables, ln).float()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 + 2**-7 * want.abs()).all())


@pytest.mark.parametrize("mode,ps,group,S,hd,lens,n_pp", B5_SPLIT_CASES)
def test_paged_attention_split_f32_within_atol(mode, ps, group, S, hd, lens, n_pp):
    """The split and its chunk-order merge alone, in f32, agree with the
    plain version's one softmax over the whole table within atol 2e-5."""
    Hkv = 2
    written = [min(n + S - 1, n_pp * ps) for n in lens]
    _, pool, tables = _pools(mode, written, ps, Hkv, hd, n_pp, seed=ps + S + 1)
    tables = torch.from_numpy(tables)
    rng = np.random.default_rng(S + hd + 1)
    q = torch.from_numpy(rng.standard_normal((len(lens), S, Hkv * group, hd))
                         .astype(np.float32))
    ln = torch.tensor(lens, dtype=torch.int32)
    got = _b5_split_emulation(q, pool, tables, ln, tensor_core=False)
    want = PA.paged_attention_plain(q, pool, tables, ln)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_paged_attention_split_plan():
    """Every call tiles its rows into 16-row query tiles over four 16-key
    parts of 64-key sub-blocks, one sub-block a chunk, and a CTA takes up to
    two tiles, which share its K/V loads, and writes one partial a chunk
    and row; chunks come from the table width
    (qwen3-1.7b's engine: 41 columns of 16), and wider tables take more
    sub-blocks a CTA, and one tile, so that no plan has more than MAX_CHUNKS
    chunks (at 32768 positions too).  Only the number of tiles depends on
    the rows: a row's partials, and so its bits, are the same at decode, in
    a verify and in a prefill chunk (qwen3-moe's group of 16: R = 16, 80 and
    1024)."""
    assert PA.split_plan(1, 16, 8, 16, 41) == PA.SplitPlan(1, 1, 1, 11)
    assert PA.split_plan(64, 16, 8, 16, 41) == PA.SplitPlan(2, 1, 8, 11)
    assert PA.split_plan(12, 16, 8, 16, 40) == PA.SplitPlan(2, 1, 2, 10)
    assert PA.split_plan(3, 8, 2, 8, 12) == PA.SplitPlan(1, 1, 1, 2)
    assert PA.split_plan(1, 16, 8, 16, 128) == PA.SplitPlan(1, 1, 1, 32)
    assert PA.split_plan(1, 16, 8, 16, 129) == PA.SplitPlan(1, 2, 1, 17)
    assert PA.split_plan(1, 16, 8, 16, 2048) == PA.SplitPlan(1, 16, 1, 32)
    assert PA.split_plan(64, 16, 8, 16, 2049) == PA.SplitPlan(1, 17, 8, 31)
    for S, tiles, n_tiles in ((1, 1, 1), (5, 2, 5), (64, 2, 64)):
        assert PA.split_plan(S, 64, 4, 16, 41) == PA.SplitPlan(tiles, 1, n_tiles, 11)
    for S in (1, 8, 9, 64):
        for n_pp in range(1, 5000, 37):
            plan = PA.split_plan(S, 16, 8, 16, n_pp)
            assert plan.n_chunks <= PA.MAX_CHUNKS
            assert plan.n_chunks * plan.blocks * PA.CHUNK_KEYS >= n_pp * 16
            assert 1 <= plan.tiles <= min(PA.MAX_TILES, plan.n_tiles)


# ---------------------------------------------------------------------------
# KV quantize-pack / unpack-dequantize (B4a, B4b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 96), (48, 32), (24, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_pack_plain_bit_exact_vs_reference(shape, dtype):
    """(17, 96) is the reference test's shape; (48, 32) and (24, 128) are
    pool rows (tokens × heads, hd) of the reduced and the full qwen3."""
    x = (np.random.default_rng(11).standard_normal(shape) * 1.7).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero group
    jc, js = JOPS.kv_quant_pack(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tc, ts = ops.kv_quant_pack(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def kv_edge_rows() -> np.ndarray:
    """Rows of two groups whose first group's absmax/6 lies within ±8 ulps
    of √2·2^k or exactly at 2^k (k in [-20, 20]), plus all-zero rows."""
    rng = np.random.default_rng(12)
    amax = []
    for k in range(-20, 21):
        a0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0)
        amax.extend((a0.view(np.int32) + np.arange(-8, 9, dtype=np.int32)).view(np.float32))
        amax.append(np.float32(6.0 * 2.0**k))
    amax = np.asarray(amax, np.float32)
    x = np.zeros((amax.size + 4, 64), np.float32)
    x[:amax.size, 1:32] = rng.uniform(-0.9, 0.9, (amax.size, 31)) * amax[:, None]
    x[:amax.size, 0] = amax * np.where(rng.random(amax.size) < 0.5, -1, 1)
    x[:amax.size, 32:] = rng.standard_normal((amax.size, 32))
    return x


def test_kv_quant_pack_edge_rows_misround_only_in_reference():
    x = kv_edge_rows()
    jc, js = (_np(a) for a in JOPS.kv_quant_pack(jnp.asarray(x)))
    tc, ts = (a.numpy() for a in KV.kv_quant_pack(torch.from_numpy(x)))
    amax6 = np.maximum(np.abs(x).reshape(-1, 2, 32).max(-1) / np.float32(6.0),
                       np.float32(2.0**-126))
    exact = np.clip(np.round(np.log2(amax6.astype(np.float64))), -126, 127) + 127
    np.testing.assert_array_equal(ts, exact.astype(np.uint8))  # the port is exact
    bad = (ts != js) | (tc.reshape(-1, 2, 16) != jc.reshape(-1, 2, 16)).any(-1)
    assert np.all(js[bad] != exact[bad])  # every disagreement: a reference misround
    assert not bad[-4:].any() and not bad[:, 1].any()


def test_kv_dequant_unpack_plain_bit_exact_and_bf16_exact():
    """Every scale code 1..254.  The one exception: XLA:CPU flushes subnormal
    results (0.5 × 2^-126 under scale code 1) to zero, while the port (and
    the card, which does not flush) keeps them exact."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    scales = rng.integers(1, 255, (40, 4), dtype=np.uint8)
    want = _np(JOPS.kv_dequant_unpack(jnp.asarray(codes), jnp.asarray(scales)))
    got = ops.kv_dequant_unpack(torch.from_numpy(codes), torch.from_numpy(scales))
    diff = got.numpy().view(np.int32) != want.view(np.int32)
    assert np.all(want[diff] == 0) and np.all(np.abs(got.numpy()[diff]) == 2.0**-127)
    sub = np.abs(got.numpy()) < 2.0**-126
    np.testing.assert_array_equal(diff, sub & (got.numpy() != 0))
    bf = ops.kv_dequant_unpack(torch.from_numpy(codes), torch.from_numpy(scales),
                               torch.bfloat16)
    assert torch.equal(bf.view(torch.int16), got.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(bf.float(), got)  # writing bf16 directly is exact


def test_kv_scatter_and_gather_forms_equal_the_2d_forms():
    """The fused forms (pool leaf in place; through page tables) equal the
    2-d quantize / dequantize of the same rows, for one layer and for all."""
    rng = np.random.default_rng(14)
    L, n_pages, ps, H, hd = 2, 6, 4, 2, 64
    codes = torch.zeros((L, n_pages, ps, H, hd // 2), dtype=torch.uint8)
    scales = torch.zeros((L, n_pages, ps, H, hd // 32), dtype=torch.uint8)
    pid = torch.tensor([3, 1, 5, 3], dtype=torch.int32)
    off = torch.tensor([0, 2, 3, 1], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((L, 4, H, hd)).astype(np.float32))
    KV.kv_quant_scatter(codes, scales, pid, off, x)
    c2, s2 = KV.kv_quant_pack(x.reshape(-1, hd))
    assert torch.equal(codes[:, pid.long(), off.long()].reshape(-1, hd // 2), c2)
    assert torch.equal(scales[:, pid.long(), off.long()].reshape(-1, hd // 32), s2)
    one_c, one_s = codes[1].clone(), scales[1].clone()
    KV.kv_quant_scatter(one_c, one_s, pid, off, x[1] * 3)
    assert torch.equal(one_c[pid.long(), off.long()].reshape(-1, hd // 2),
                       KV.kv_quant_pack(x[1].reshape(-1, hd) * 3)[0])
    tables = torch.tensor([[3, 1], [5, 0]], dtype=torch.int32)
    dense = KV.kv_gather_dequant(codes, scales, tables, torch.float32)
    assert dense.shape == (L, 2, 2 * ps, H, hd)
    want = KV.kv_dequant_unpack(codes[:, tables.long()].reshape(-1, hd // 2),
                                scales[:, tables.long()].reshape(-1, hd // 32))
    assert torch.equal(dense.reshape(-1, hd), want)
    with pytest.raises(ValueError, match="does not fit"):
        KV.kv_quant_scatter(codes, scales, pid, off, x[:, :3])


# ---------------------------------------------------------------------------
# flash attention (B6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,t,causal", [(128, 128, True), (128, 128, False),
                                        (256, 384, False), (100, 150, False),
                                        (64, 64, True)])
def test_flash_attention_plain_vs_reference(s, t, causal):
    """The reference test's sweep (tests/test_kernels.py), 64-blocks."""
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal((4, n, 64)).astype(np.float32) for n in (s, t, t))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  block_q=64, block_k=64)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (6, 3), (4, 4)])
def test_mha_flash_gqa_vs_reference(hq, hkv):
    rng = np.random.default_rng(16)
    B, S, hd = 2, 80, 32
    q = rng.standard_normal((B, S, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, hkv, hd)).astype(np.float32) for _ in range(2))
    want = jmha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ops.mha_flash(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert got.shape == (B, S, hq, hd)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def _b6_tensor_core_emulation(q, k, v, causal, q_heads=1, kv_heads=1, split=True):
    """The card's bf16 B6 design in PyTorch: unscaled scores from the bf16
    operands in f32, p = 2^(s·c − m·c) with c = scale·log2 e and m the
    running max of unscaled scores; the online softmax over 64-key blocks;
    P split into hi = bf16(p) and lo = bf16(p - hi), both products taken
    (``split=False``: P rounded once to bf16, the design the kernel avoids)."""
    bh, s, hd = q.shape
    t = k.shape[1]
    rows = torch.arange(bh)
    kv_row = (rows // q_heads) * kv_heads + (rows % q_heads) // (q_heads // kv_heads)
    kf, vf = k.float()[kv_row], v.float()[kv_row]
    qf = q.float()
    out = torch.empty_like(q)
    c = FA._scale(hd) * 1.4426950408889634
    for q0 in range(0, s, 64):
        qb = qf[:, q0:q0 + 64]
        q_pos = torch.arange(q0, q0 + qb.shape[1])[:, None]
        m = torch.full(qb.shape[:2], FA.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, t, 64):
            if causal and k0 > q0 + 63:
                break
            sc = torch.einsum("bqd,bkd->bqk", qb, kf[:, k0:k0 + 64])
            k_pos = torch.arange(k0, min(k0 + 64, t))[None, :]
            mask = (q_pos >= k_pos) if causal else torch.ones_like(sc[0], dtype=torch.bool)
            sc = torch.where(mask, sc, torch.full_like(sc, FA.NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp2(sc * c - (m_new * c)[..., None])
            corr = torch.exp2((m - m_new) * c)
            l = l * corr + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float() if split else torch.zeros_like(p)
            vb = vf[:, k0:k0 + 64]
            acc = acc * corr[..., None] + (hi @ vb + lo @ vb)
            m = m_new
        out[:, q0:q0 + 64] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s,t,causal,hq,hkv", [(192, 192, True, 2, 2), (100, 150, False, 4, 2),
                                               (130, 70, False, 2, 1)])
def test_flash_attention_split_p_arithmetic_within_bf16_check(hd, s, t, causal, hq, hkv):
    """The kernel's bf16 arithmetic against the plain version, held to the
    card check's bf16 tolerance, |Δ| <= 1e-5 + 2^-7·|plain|."""
    rng = np.random.default_rng(hd + s + t)
    q = torch.from_numpy(rng.standard_normal((2 * hq, s, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((2 * hkv, t, hd)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    got = _b6_tensor_core_emulation(q, k, v, causal, hq, hkv).float()
    want = FA.flash_attention_plain(q, k, v, causal, q_heads=hq, kv_heads=hkv).float()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 + 2**-7 * want.abs()).all())


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_unsplit_p_fails_bf16_check(hd):
    """Why the kernel splits P: rounded once to bf16, P moves outputs past
    the same check (outputs near zero, sums of terms of both signs)."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 192, hd)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = FA.flash_attention_plain(q, k, v, True).float()
    got = _b6_tensor_core_emulation(q, k, v, True, split=False).float()
    assert bool(((got - want).abs() > 1e-5 + 2**-7 * want.abs()).any())


def test_flash_attention_raises_under_grad():
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32)
    with pytest.raises(NotImplementedError, match="no backward"):
        FA.mha_flash(q, k, k)
    with torch.no_grad():  # evaluation: no graph, so the op runs
        assert FA.mha_flash(q, k, k).shape == (1, 8, 2, 32)


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_only_on_cpu_and_count_only_launches():
    ops.reset_launch_counts()
    x = torch.randn(8, 64)
    c, s, _ = ops.hadamard_quest_quantize(x)
    ops.mxfp4_matmul(c, s, c.t(), s.t())
    sc, ss = ops.sr_hadamard_quantize(x.reshape(2, 4, 64), torch.ones(64), 3, salt=1)
    assert sc.shape == (2, 4, 64) and ss.shape == (2, 4, 2)
    assert torch.equal(sc.reshape(8, 64), SR.sr_hadamard_quantize_plain(x, torch.ones(64), 3,
                                                                        salt=1)[0])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    ops.kv_dequant_unpack(*ops.kv_quant_pack(x))
    leaves = [torch.zeros((3, 2, 1, w), dtype=torch.uint8) for w in (32, 2, 32, 2)]
    ops.kv_quant_scatter_kv(*leaves, torch.tensor([1, 2]), torch.tensor([0, 1]),
                            x[:2, None], x[2:4, None])
    ops.mha_flash(x.reshape(1, 8, 2, 32), x.reshape(1, 8, 2, 32), x.reshape(1, 8, 2, 32))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert ops.vector_launches() == {"hadamard_quest_quantize": 0, "sr_hadamard_quantize": 0}
    assert set(ops.KERNELS) == {"hadamard_quest_quantize", "sr_hadamard_quantize",
                                "mxfp4_matmul", "paged_attention", "kv_quant_pack",
                                "kv_dequant_unpack", "flash_attention"}
    meta = torch.empty((8, 64), device="meta")
    u8 = meta.to(torch.uint8)
    for call in (lambda: HQ.hadamard_quest_quantize(meta),
                 lambda: SR.sr_hadamard_quantize(meta, torch.ones(64), 0),
                 lambda: MM.mxfp4_matmul(meta.to(torch.int8), meta[:, :2], meta.t(),
                                         meta[:, :2].t()),
                 lambda: KV.kv_quant_pack(meta),
                 lambda: KV.kv_dequant_unpack(u8[:, :32], u8[:, :2]),
                 lambda: ops.kv_quant_scatter_kv(*(u8[:, None, None, :w] for w in (32, 2, 32, 2)),
                                                 u8[:1, 0], u8[:1, 0], meta[:1, None],
                                                 meta[:1, None]),
                 lambda: FA.mha_flash(meta.reshape(1, 8, 2, 32), meta.reshape(1, 8, 2, 32),
                                      meta.reshape(1, 8, 2, 32))):
        with pytest.raises(RuntimeError, match="unsupported device"):
            call()


def _mha_flash_plain(q, k, v, causal):
    """B6's plain version over [B, S, Hq, hd] x [B, T, Hkv, hd] on the
    operands' own device (``mha_flash`` runs it for CPU tensors)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = FA.flash_attention_plain(*(t.transpose(1, 2).reshape(-1, t.shape[1], hd)
                                   for t in (q, k, v)), causal, q_heads=Hq, kv_heads=Hkv)
    return o.reshape(B, Hq, S, hd).transpose(1, 2)


def _attention_f64(q, k, v, causal):
    """Softmax attention over [B, S, Hq, hd] x [B, T, Hkv, hd] in float64,
    one softmax over all keys (GQA: query head j reads KV head j // group;
    causal: query s sees keys t <= s)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kk, vv = (t.double().repeat_interleave(Hq // Hkv, dim=2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.double(), kk) / np.sqrt(hd)
    if causal:
        pos = torch.arange(max(S, T), device=q.device)
        s = s.masked_fill(pos[None, :T] > pos[:S, None], -torch.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), vv)


def _check_b5_bf16(mode, hd, S, lens, n_pp, seed, gen):
    """B5 with bf16 queries (the tensor-core body) on the card against its
    plain version, |Δ| <= 1e-5 + 2^-7·|plain|: group 2, 4 slots, pages of
    16, the table ``n_pp`` wide (default: one page past the longest slot);
    on the packed pool slot 2's second page carries E8M0 scale codes 1 and
    2."""
    dev = "cuda"
    written = [n + S - 1 for n in lens]
    _, tpool, tables = _pools(mode, written, 16, 2, hd, n_pp or -(-max(written) // 16) + 1,
                              seed=seed)
    tpool = {n: (t.to(torch.bfloat16) if mode == "dense" else t).to(dev)
             for n, t in tpool.items()}
    if mode == "mxfp4":
        page = int(tables[2, 1])
        for name in ("k_scales", "v_scales"):
            tpool[name][page] = torch.randint(1, 3, tpool[name][page].shape,
                                              generator=gen, device=dev).to(torch.uint8)
    q = torch.randn((4, S, 4, hd), generator=gen, device=dev).to(torch.bfloat16)
    q = q[:, 0] if S == 1 else q
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tb = torch.from_numpy(tables).to(dev)
    got = PA.paged_attention(q, tpool, tb, ln).float()
    want = PA.paged_attention_plain(q, tpool, tb, ln).float()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-5 + 2**-7 * want.abs()).all()), (mode, hd, S, n_pp)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel against its plain version on the card (small shapes; the
    full-width check is chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((96, 256), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((256, 160), generator=gen, device=dev).to(torch.bfloat16)
    for t in (x, w.t()):
        for a, b in zip(HQ.hadamard_quest_quantize(t), HQ.hadamard_quest_quantize_plain(t)):
            assert torch.equal(a, b)
    # B1 bit for bit on its vector body at ragged M (a 1000-row Wᵀ), K = 32
    # and f32, and on its tile body for views that are not 16-byte aligned
    w1000 = torch.randn((256, 1000), generator=gen, device=dev).to(torch.bfloat16)
    x37 = torch.randn((37, 32), generator=gen, device=dev).mul_(3.0)
    for t, vector in ((w1000.t(), True), (x37, True), (x37.to(torch.bfloat16), True),
                      (w[:32].t(), True), (w1000.t().float(), True),
                      (x[:, 3:3 + 224], False), (w1000[:, 1:993].t(), False)):
        before = HQ.hadamard_quest_quantize.vector_launches
        for a, b in zip(HQ.hadamard_quest_quantize(t), HQ.hadamard_quest_quantize_plain(t)):
            assert torch.equal(a, b)
        assert HQ.hadamard_quest_quantize.vector_launches - before == int(vector)
    signs = torch.where(torch.rand(256, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    for t in (x.float(), x, x.t().contiguous().t(), w.t().float()):
        s = signs[:t.shape[1]]
        for a, b in zip(SR.sr_hadamard_quantize(t, s, 7, salt=3),
                        SR.sr_hadamard_quantize_plain(t, s, 7, salt=3)):
            assert torch.equal(a, b)
    ac, asc, _ = HQ.hadamard_quest_quantize(x)
    bc, bsc, _ = HQ.hadamard_quest_quantize(w.t())
    torch.testing.assert_close(MM.mxfp4_matmul(ac, asc, bc.t(), bsc.t()),
                               MM.mxfp4_matmul_plain(ac, asc, bc.t(), bsc.t()),
                               rtol=1e-6, atol=1e-5)
    # bit for bit at ragged shapes (each tile configuration) and at scale
    # codes 1, 2, 253, 254 (the E8M0 edges) beside normal ones
    for m, k, n in ((8, 256, 1000), (100, 96, 50), (1100, 64, 130)):
        args = tuple(t.to(dev) for t in _b3_operands(m, k, n, seed=m))
        assert torch.equal(MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args))
        a, sa, b, sb = args
        edge = torch.tensor([1, 2, 253, 254, 127], dtype=torch.int32, device=dev)
        ea, eb = ((edge[torch.randint(0, 5, t.shape, generator=gen, device=dev)] << 23)
                  .view(torch.float32) for t in (sa, sb))
        a, b = a.abs(), b.abs()  # no inf - inf: terms are +inf, finite or 0
        assert torch.equal(MM.mxfp4_matmul(a, ea, b, eb), MM.mxfp4_matmul_plain(a, ea, b, eb))
    for mode in ("dense", "mxfp4"):
        _, tpool, tables = _pools(mode, [9, 30, 1], 8, 2, 64, 5, seed=3)
        tpool = {n: t.to(dev) for n, t in tpool.items()}
        q = torch.randn((3, 4, 4, 64), generator=gen, device=dev)
        ln = torch.tensor([6, 27, 1], dtype=torch.int32, device=dev)
        tb = torch.from_numpy(tables).to(dev)
        torch.testing.assert_close(PA.paged_attention(q, tpool, tb, ln),
                                   PA.paged_attention_plain(q, tpool, tb, ln),
                                   rtol=0, atol=2e-5)
    # B5 bf16 on the tensor-core body: hd 128, group 2, S = 1 and 64, both
    # pools, lengths 1, 16, 33, 100, and a page with E8M0 scale codes 1 and 2
    lens = [1, 16, 33, 100]
    for mode in ("dense", "mxfp4"):
        for S in (1, 64):
            _check_b5_bf16(mode, 128, S, lens, None, S, gen)
    # and (own generator, so the draws above and below stay as they were) at
    # hd 64, S = 1, 12 (24 rows: a second, partial tile) and 64, and
    # over a table of 32768 positions (qwen3-1.7b's published context: 16
    # sub-blocks a CTA under the chunk cap) with short and long slots
    gen_b5 = torch.Generator(device=dev).manual_seed(1)
    cases = [(64, S, lens, None) for S in (1, 12, 64)] + [(128, 12, lens, None)]
    cases += [(128, S, [1, 700, 32768 - S + 1, 9000], 2048) for S in (1, 64)]
    for hd, S, ln, n_pp in cases:
        for mode in ("dense", "mxfp4"):
            _check_b5_bf16(mode, hd, S, ln, n_pp, S + hd, gen_b5)
    xe = torch.from_numpy(kv_edge_rows()).to(dev)
    for t in (xe, x, x.float()):
        for a, b in zip(KV.kv_quant_pack(t), KV.kv_quant_pack_plain(t)):
            assert torch.equal(a, b)
    c, s = KV.kv_quant_pack(x)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(KV.kv_dequant_unpack(c, s, dt), KV.kv_dequant_unpack_plain(c, s, dt))
    # B6 against its plain version run on the card: on the host CPU of the
    # card's machine that version now and then came out ~6e-5 off a float64
    # reference (the card's result within 5e-7), and differently when run
    # again (ROADMAP Queue C).  A float64 evaluation is the second witness.
    for S, T, hq, hkv, causal in ((130, 130, 4, 2, True), (70, 150, 2, 1, False)):
        q = torch.randn((2, S, hq, 64), generator=gen, device=dev)
        k, v = (torch.randn((2, T, hkv, 64), generator=gen, device=dev) for _ in range(2))
        got = FA.mha_flash(q, k, v, causal=causal)
        torch.testing.assert_close(got, _mha_flash_plain(q, k, v, causal), rtol=0, atol=2e-5)
        torch.testing.assert_close(got.double(), _attention_f64(q, k, v, causal),
                                   rtol=0, atol=2e-5)
    # bf16 on the tensor-core body, hd 64 and 128: one bf16 step of the plain version
    for S, T, hq, hkv, hd, causal in ((700, 1000, 4, 2, 64, False), (130, 130, 2, 2, 128, True)):
        q = torch.randn((1, S, hq, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((1, T, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        got = FA.mha_flash(q, k, v, causal=causal).float()
        want = _mha_flash_plain(q, k, v, causal).float()
        assert bool(((got - want).abs() <= 1e-5 + 2**-7 * want.abs()).all())
