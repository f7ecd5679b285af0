"""The vector designs of B2 (SR-Hadamard quantize) and B4a (KV quantize-scatter).

B2's vector body (``csrc/sr_hadamard_quant.cu``) keeps a whole 32-group in
one thread's registers, divides once a group (absmax / 6) and replaces the
plain version's divisions by powers of two with multiplies by their exact
reciprocals: v / 2^e as v · 2^-e built from the bits (2^-127 as a
subnormal), a / step as a product with 2^(1−E), and (a − lo) / step as
x − floor(x) of that product; the half-code is min(r·2^E, 12) with v's sign,
its byte the low byte of t + 1.5·2^23.  The emulation below does the
kernel's arithmetic in PyTorch, and must equal
``sr_hadamard_quantize_plain`` bit for bit: every scale exponent from −126
to 127, every step binade, ties u = p_up, saturation at 6.  It hashes each
element's uniform from the group's first index by adding i·2654435761, which
must equal ``fastrng``'s bits.  The body is taken at every operand the
training path gives it.

B4a writes a layer's K and V in one launch (``kv_quant_scatter_kv``); on the
CPU it must equal two ``kv_quant_scatter`` calls, also for the strided views
the gather backend passes and with duplicate scratch-page writes.

The ``cuda`` test holds both kernels to their plain versions on the card
and skips here.  Tolerance everywhere: bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core import fastrng as JR
from repro_torch.core import fastrng
from repro_torch.core.quartet import QuartetConfig, _backward_kernels, _forward_kernels
from repro_torch.kernels import kv_pack as KV
from repro_torch.kernels import ops
from repro_torch.kernels import sr_hadamard_quant as SR
from repro_torch.kernels.hadamard_quant import _H_SCALE, _butterfly32, vector_ok
from test_torch_kernels import kv_edge_rows

GROUP = 32
INDEX_MUL = 2654435761


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).view(torch.float32)


def _b2_vector_emulation(x, signs, prescale, u):
    """The vector body's arithmetic on x [M, K] with uniforms u [M, K]:
    returns (codes, scales, v, p_up) where v = xh · 2^-e is the scaled value
    and p_up the SR's probability of rounding up."""
    m, k = x.shape
    xs = x.to(torch.float32) * signs.to(torch.float32)[None, :]
    xh = _butterfly32(xs.reshape(m, k // GROUP, GROUP)) * _H_SCALE * prescale
    # once a group: the one division, the E8M0-ceil and 2^-e from the bits
    raw = torch.clamp(torch.amax(xh.abs(), -1) / torch.tensor(6.0), min=2.0**-126)
    b = _bits(raw)
    e = torch.clamp(((b >> 23) & 0xFF) - 127 + ((b & 0x7FFFFF) >= 6).to(torch.int32), -126, 127)
    inv = torch.where(e < 127, _from_bits((127 - e) << 23), _from_bits(torch.tensor(0x00400000)))
    # per element: 2^E and 2^(1−E) from the exponent field of max(|v|, 1);
    # x = |v| / step as a product, p_up = x − floor(x), the half-code
    # min(r·2^E, 12) with r = floor(x) (+ 1 when u < p_up), v's sign
    v = xh * inv[..., None]
    a = v.abs()
    fb = _bits(torch.fmax(a, torch.tensor(1.0))) & 0x7F800000
    x = a * _from_bits(0x7F800000 - fb)
    f = torch.floor(x)
    p_up = x - f
    ug = u.reshape(m, k // GROUP, GROUP)
    r = torch.where(ug < p_up, f + 1.0, f)
    t = torch.copysign(torch.fmin(r * _from_bits(fb), torch.tensor(12.0)), v)
    codes = (_bits(t + 12582912.0) & 0xFF).to(torch.uint8).view(torch.int8).reshape(m, k)
    return codes, _from_bits((e + 127) << 23), v.reshape(m, k), p_up.reshape(m, k)


def _plain_with_uniforms(monkeypatch, x, signs, prescale, u):
    """sr_hadamard_quantize_plain fed ``u`` in place of its hashed uniforms."""
    with monkeypatch.context() as mp:
        mp.setattr(SR.fastrng, "uniform", lambda *a, **k: u)
        return SR.sr_hadamard_quantize_plain(x, signs, 0, prescale)


def _sweep_rows(rng):
    """Rows [n, 64] f32 whose groups span every scale exponent the default
    prescale reaches: normal values at magnitudes 2^-150 .. 2^122, a zero
    group, subnormal groups, and groups whose largest scaled value lands a
    few ulps above 6 (E8M0-ceil keeps 2^k for mantissa fields below 6)."""
    mags = np.exp2(np.arange(-150.0, 122.0, 0.25))
    x = rng.standard_normal((mags.size, 64)) * mags[:, None]
    special = np.zeros((4, 64))
    special[1] = 1e-45 * rng.integers(-3, 4, 64)  # subnormal inputs
    special[2, :32] = 2.0**-140
    # one-hot groups: every element of xh is ±fl(fl(c·H)·¾); c swept over
    # ulps of 6·2^k / (H·¾) so that amax / 6 falls just above 2^k
    c0 = np.float32(6.0 / (np.float32(_H_SCALE) * np.float32(0.75)))
    ulps = (c0.view(np.int32) + np.arange(-40, 41, dtype=np.int32)).view(np.float32)
    onehot = np.zeros((ulps.size * 3, 64))
    for i, s in enumerate((2.0**-60, 1.0, 2.0**60)):
        onehot[i * ulps.size:(i + 1) * ulps.size, 0] = ulps * s
        onehot[i * ulps.size:(i + 1) * ulps.size, 32] = -ulps * s
    return np.concatenate([x, special, onehot]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b2_vector_arithmetic_bit_exact_vs_plain(dtype, monkeypatch):
    """Codes and scales of the emulation equal the plain version's, with the
    hashed uniforms and with uniforms set to p_up exactly (ties), and the
    sweep reaches every step binade, ties and saturation."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(_sweep_rows(rng)).to(getattr(torch, dtype))
    signs = fastrng.rademacher(4, 64, salt=11)
    u_hash = fastrng.uniform(9, tuple(x.shape), 3)
    codes, scales, v, p_up = _b2_vector_emulation(x, signs, 0.75, u_hash)
    want = SR.sr_hadamard_quantize_plain(x, signs, 9, 0.75, 3)
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    # uniforms on the hash's 2^-24 grid set to p_up wherever p_up is on it,
    # and to 0 above 6, where rounding up (to 8) saturates at 6
    on_grid = (p_up * 2.0**24) == torch.floor(p_up * 2.0**24)
    u_tie = torch.where(v.abs() > 6.0, 0.0, torch.where(on_grid, p_up, u_hash))
    got = _b2_vector_emulation(x, signs, 0.75, u_tie)
    want = _plain_with_uniforms(monkeypatch, x, signs, 0.75, u_tie)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if dtype == "float32":  # the one-hot groups keep their f32 ulps
        a = v.abs()
        ties = on_grid & (p_up > 0)
        for lo_b, hi_b in ((0.0, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 6.0)):
            assert bool(((a >= lo_b) & (a < hi_b) & ties).any()), (lo_b, hi_b)
        assert bool((a > 6.0).any())


def test_b2_vector_arithmetic_every_scale_exponent(monkeypatch):
    """E8M0-ceil exponents −126 .. 127 through the whole function: the
    default prescale reaches −126 .. 122 (the Hadamard's sums stay finite),
    prescales 2^4 and 2^8 the exponents up to 126, and a group holding an
    infinity 127 (every code ±12)."""
    rng = np.random.default_rng(22)
    signs = fastrng.rademacher(5, 64, salt=12)
    seen = set()
    cases = [(_sweep_rows(rng), 0.75)]
    top = np.exp2(np.arange(110.0, 119.0, 0.125))  # Hadamard sums below 2^126
    cases += [(rng.standard_normal((top.size, 64)) * top[:, None], p) for p in (16.0, 256.0)]
    inf_row = rng.standard_normal((2, 64))
    inf_row[0, 5] = np.inf
    inf_row[1, 40] = -np.inf
    cases.append((inf_row, 0.75))
    for xn, prescale in cases:
        x = torch.from_numpy(xn.astype(np.float32))
        u = fastrng.uniform(1, tuple(x.shape), 7)
        codes, scales, _, _ = _b2_vector_emulation(x, signs, prescale, u)
        want = _plain_with_uniforms(monkeypatch, x, signs, prescale, u)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1]), prescale
        seen |= set(((_bits(scales) >> 23) - 127).flatten().tolist())
    assert set(range(-126, 128)) <= seen


def test_b2_hash_from_group_base_equals_fastrng():
    """Element i of a group hashes h0 + i·2654435761 (mod 2^32), h0 the
    group's first index times the multiplier plus the seed and salt terms:
    equal to fastrng's uniforms, and to the reference's, of the logical
    index."""
    m, k, seed, salt = 48, 320, 0xDEADBEEF, 4
    idx = np.arange(m * k, dtype=np.uint64).reshape(m, k)
    seed_salt = np.uint32((seed * 2246822519 + salt * 3266489917) % 2**32)
    base = (idx[:, ::GROUP] * INDEX_MUL % 2**32).astype(np.uint32)
    with np.errstate(over="ignore"):
        h0 = base + seed_salt
        h = (h0[:, :, None] + (np.arange(GROUP, dtype=np.uint32) * np.uint32(INDEX_MUL))
             [None, None, :]).reshape(m, k)

        def fmix(v):
            v = v ^ (v >> np.uint32(16))
            v = v * np.uint32(0x85EBCA6B)
            v = v ^ (v >> np.uint32(13))
            v = v * np.uint32(0xC2B2AE35)
            return v ^ (v >> np.uint32(16))

        bits = fmix(fmix(h) + np.uint32(0x9E3779B9))
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)
    np.testing.assert_array_equal(u, fastrng.uniform(seed, (m, k), salt).numpy())
    np.testing.assert_array_equal(u, np.asarray(JR.uniform(np.uint32(seed), (m, k), salt)))


class _RecordingOps:
    """``kernels.ops`` (plain versions on the CPU), recording every operand
    that reaches ``sr_hadamard_quantize``."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(ops, name)

    def sr_hadamard_quantize(self, x, signs, seed, prescale=0.75, salt=0):
        self.seen.append(x)
        return ops.sr_hadamard_quantize(x, signs, seed, prescale, salt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b2_vector_body_taken_at_every_training_operand(dtype):
    """``quartet._backward_kernels`` at llama-paper-200m's linear shapes (K
    1280, N 1280 / 3456 and the down projection's 3456 × 1280): dy
    row-major, and the Wq, xqᵀ and dyᵀ views with unit stride along M, all
    take the vector body, for a bf16 and an f32 gradient."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for kdim, n in ((1280, 1280), (1280, 3456), (3456, 1280)):
        x = torch.randn((2, 32, kdim), generator=gen).to(dt)
        w = (torch.randn((kdim, n), generator=gen) / kdim**0.5).to(dt)
        dy = (torch.randn((2, 32, n), generator=gen) * 1e-3).to(dt)
        rec = _RecordingOps()
        cfg = QuartetConfig(use_kernels=True)
        _, res = _forward_kernels(x, w, cfg, ops=rec)
        _backward_kernels(cfg, 3, res, dy, ops=rec)
        assert len(rec.seen) == 4
        row_major = [t.stride(1) == 1 for t in rec.seen]
        assert row_major == [True, False, False, False], [t.stride() for t in rec.seen]
        assert all(vector_ok(t) for t in rec.seen), [(t.shape, t.stride()) for t in rec.seen]


def _pool(L, n_pages, ps, H, hd):
    return [torch.zeros((L, n_pages, ps, H, w), dtype=torch.uint8)
            for w in (hd // 2, hd // 32, hd // 2, hd // 32)]


@pytest.mark.parametrize("layers", [1, 3])
def test_kv_scatter_kv_equals_two_scatters(layers):
    """One call for K and V writes the same pool bytes as two
    ``kv_quant_scatter`` calls: one layer's leaves and all layers', dense
    rows, the gather backend's strided slices of its dense caches
    (``k2[:, 0, s0:s0 + C]`` and ``k2[:, bidx, pos]``), and lanes redirected
    to the scratch page 0 (compared past it only)."""
    rng = np.random.default_rng(23)
    L, n_pages, ps, H, hd, B, T = 3, 9, 4, 2, 64, 3, 20
    k2, v2 = (torch.from_numpy(rng.standard_normal((L, B, T, H, hd)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    s0, C = 5, 6
    bidx = torch.arange(B)
    pos = torch.tensor([3, 11, 19])
    cases = [(k2[:, 0, s0:s0 + C], v2[:, 0, s0:s0 + C]),  # strided slices
             (k2[:, bidx, pos], v2[:, bidx, pos]),
             (k2[:, 1, :4].contiguous(), v2[:, 1, :4].contiguous())]
    for k, v in cases:
        n = k.shape[1]
        perm = torch.from_numpy(rng.permutation((n_pages - 1) * ps)[:n])
        pid = (1 + perm // ps).to(torch.int32)
        off = (perm % ps).to(torch.int32)
        pid[::3] = 0  # masked lanes: duplicate writes to the scratch page
        fused, twice = _pool(L, n_pages, ps, H, hd), _pool(L, n_pages, ps, H, hd)
        if layers == 1:
            k, v = k[1], v[1]
            fused, twice = [t[1] for t in fused], [t[1] for t in twice]
        KV.kv_quant_scatter_kv(*fused, pid, off, k, v)
        KV.kv_quant_scatter(twice[0], twice[1], pid, off, k)
        KV.kv_quant_scatter(twice[2], twice[3], pid, off, v)
        for a, b in zip(fused, twice):
            assert torch.equal(a[..., 1:, :, :, :], b[..., 1:, :, :, :])
        live = pid != 0
        want = KV.kv_quant_pack_plain(v.reshape(-1, hd))[0].reshape(*v.shape[:-1], hd // 2)
        got = fused[2][..., pid[live].long(), off[live].long(), :, :]
        assert torch.equal(got, want[..., live, :, :])
    with pytest.raises(ValueError, match="does not fit"):
        KV.kv_quant_scatter_kv(*_pool(L, n_pages, ps, H, hd), pid, off, k2[:, 0, :n],
                               v2[:, 0, :n + 1])


@pytest.mark.cuda
def test_b2_and_b4a_redesigns_bit_exact_on_card():
    """B2 against its plain version on the card: ragged M (a 1000-row view),
    K = 32, an unaligned column slice (tile body), and each operand layout
    of llama-paper-200m's up and down projections at 512 tokens, bf16 and
    f32, counting vector-body launches; B4a's one-launch K+V scatter
    against two plain scatters at 8 and 512 tokens, one layer and all,
    with E8M0-edge rows and strided inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    w1000 = torch.randn((256, 1000), generator=gen, device=dev)
    cases += [(w1000.t(), True), (w1000.t().to(torch.bfloat16), True),
              (torch.randn((1000, 64), generator=gen, device=dev), True),
              (torch.randn((37, 32), generator=gen, device=dev).mul_(3.0), True),
              (torch.randn((37, 32), generator=gen, device=dev).to(torch.bfloat16), True),
              (w1000[:, 3:3 + 224], False), (w1000[:, 1:993].t(), False)]
    T = 512
    for kdim, n in ((1280, 3456), (3456, 1280)):
        for dt in (torch.bfloat16, torch.float32):
            wq = torch.randn((n, kdim), generator=gen, device=dev).t()  # Wq [K, N]
            xq = torch.randn((T, kdim), generator=gen, device=dev)
            dy = (torch.randn((T, n), generator=gen, device=dev) * 1e-3).to(dt)
            cases += [(dy, True), (wq, True), (xq.t(), True), (dy.t(), True)]
    for i, (x, vector) in enumerate(cases):
        signs = fastrng.rademacher(i, x.shape[1], salt=11, device=dev)
        before = SR.sr_hadamard_quantize.vector_launches
        got = SR.sr_hadamard_quantize(x, signs, 1234 + i, salt=i % 4 + 1)
        want = SR.sr_hadamard_quantize_plain(x, signs, 1234 + i, salt=i % 4 + 1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (i, x.shape)
        assert SR.sr_hadamard_quantize.vector_launches - before == int(vector)

    L, n_pages, ps, H, hd = 2, 1 + 64, 16, 8, 128
    edge = torch.from_numpy(kv_edge_rows()).to(dev).reshape(-1, hd)
    for n_tok in (8, 512):
        for layers in (1, L):
            k2, v2 = (torch.randn((layers, 2, n_tok + 3, H, hd), generator=gen, device=dev)
                      .mul_(1.5).to(torch.bfloat16) for _ in range(2))
            k, v = k2[:, 1, 2:2 + n_tok], v2[:, 1, 2:2 + n_tok]  # strided, as steps.py slices
            rows = min(edge.shape[0], layers * n_tok * H)
            v = v.contiguous()
            v.view(-1, hd)[:rows] = edge[:rows].to(torch.bfloat16)
            perm = torch.randperm((n_pages - 1) * ps, generator=gen, device=dev)[:n_tok]
            pid = (1 + perm // ps).to(torch.int32)
            off = (perm % ps).to(torch.int32)
            pools = [[torch.zeros((layers, n_pages, ps, H, w), dtype=torch.uint8, device=dev)
                      for w in (hd // 2, hd // 32, hd // 2, hd // 32)] for _ in range(2)]
            kk, vv = (k[0], v[0]) if layers == 1 else (k, v)
            fused = [t[0] for t in pools[0]] if layers == 1 else pools[0]
            before = KV.kv_quant_pack.launches
            KV.kv_quant_scatter_kv(*fused, pid, off, kk, vv)
            assert KV.kv_quant_pack.launches - before == 1
            for (c, s), x in (((0, 1), k), ((2, 3), v)):
                cc, ss = KV.kv_quant_pack_plain(x.reshape(-1, hd))
                pools[1][c][:, pid.long(), off.long()] = cc.reshape(*x.shape[:3], -1)
                pools[1][s][:, pid.long(), off.long()] = ss.reshape(*x.shape[:3], -1)
            for a, b in zip(*pools):
                assert torch.equal(a, b), (n_tok, layers)
    # the 2-d form on the same body, f32 edge rows and bf16
    for t in (edge, edge.to(torch.bfloat16)):
        for a, b in zip(KV.kv_quant_pack(t), KV.kv_quant_pack_plain(t)):
            assert torch.equal(a, b)
