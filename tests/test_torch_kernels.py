"""PyTorch port vs the JAX reference: the serving and training kernels.

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
atol 1e-5 in f32 (online vs full softmax, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quartet import QuartetConfig as JQuartetConfig
from repro.core.quartet import quartet_linear as jquartet_linear
from repro.core import fastrng as JR
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JREF
from repro.kernels.hadamard_quant import hadamard_quest_quantize as jhq
from repro.kernels.mxfp4_matmul import mxfp4_matmul as jmm
from repro.kernels.sr_hadamard_quant import sr_hadamard_quantize as jsr
from repro_torch.core.hadamard import hadamard_transform
from repro_torch.core.quartet import QuartetConfig, quartet_linear
from repro_torch.kernels import hadamard_quant as HQ
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
    assert set(ops.KERNELS) == {"hadamard_quest_quantize", "sr_hadamard_quantize",
                                "mxfp4_matmul", "paged_attention"}
    meta = torch.empty((8, 64), device="meta")
    for call in (lambda: HQ.hadamard_quest_quantize(meta),
                 lambda: SR.sr_hadamard_quantize(meta, torch.ones(64), 0),
                 lambda: MM.mxfp4_matmul(meta.to(torch.int8), meta[:, :2], meta.t(),
                                         meta[:, :2].t())):
        with pytest.raises(RuntimeError, match="unsupported device"):
            call()


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
    for mode in ("dense", "mxfp4"):
        _, tpool, tables = _pools(mode, [9, 30, 1], 8, 2, 64, 5, seed=3)
        tpool = {n: t.to(dev) for n, t in tpool.items()}
        q = torch.randn((3, 4, 4, 64), generator=gen, device=dev)
        ln = torch.tensor([6, 27, 1], dtype=torch.int32, device=dev)
        tb = torch.from_numpy(tables).to(dev)
        torch.testing.assert_close(PA.paged_attention(q, tpool, tb, ln),
                                   PA.paged_attention_plain(q, tpool, tb, ln),
                                   rtol=0, atol=2e-5)
