"""B4b, the KV gather-dequantize, in the redesign that takes K and V in one launch.

``kv_gather_dequant_kv`` reads K's and V's pool pages through the page
tables into dense views, on the card in one launch of ``csrc/kv_pack.cu``
(a CTA per page of one layer, a thread per 16 bytes of output); on the CPU
it is two plain gathers.  It must equal two ``kv_gather_dequant`` calls and
the reference's ``kv_dequant_unpack`` (Pallas, interpret mode) on the
gathered rows.

The kernel's arithmetic is the plain version's: a signed E2M1 value from a
16-entry table (built by the kernel's formula) times 2^(code − 127) from the
bits, one f32 multiply, then for bf16 one rounding of that product.  The
emulation below holds it to the plain version over every (byte, scale code)
pair, compared by bit pattern (``torch.equal`` is false on NaN).  The
launch is emulated on the host, too: the C entry is replaced by a Python
function that walks the kernel's grid (chunk and tile of each CTA, its
source chunk through the tables, the short last chunk of the 2-d form) over
the raw memory the wrapper passes it, so the wrapper's geometry and its
launch count are checked here.

The ``cuda`` test holds the kernel to its plain version on the card, for
the one-leaf, K+V and 2-d forms, and skips here.  Tolerance everywhere: bit
for bit.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_pack import kv_dequant_unpack as jdequant
from repro_torch.kernels import kv_pack as KV
from repro_torch.serve import paged_cache

_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(_INT[x.dtype])


def _every_pair(shape_codes, shape_scales, shift=0):
    """Codes and scale codes in which every (byte, scale code) pair occurs
    once in every 4096 consecutive groups: byte f of the flat codes is
    (f + 16·shift) mod 256, group g's scale code (g // 16 + shift) mod 256."""
    nc = int(np.prod(shape_codes))
    ns = int(np.prod(shape_scales))
    codes = ((torch.arange(nc) + 16 * shift) % 256).to(torch.uint8).reshape(shape_codes)
    scales = ((torch.arange(ns) // 16 + shift) % 256).to(torch.uint8).reshape(shape_scales)
    return codes, scales


def _signed_e2m1_table() -> torch.Tensor:
    """The kernel's 16 signed E2M1 values (``e2m1_value``): 2^((i−2)>>1)
    built from the bits, times 1 + (i&1)/2, for i ≥ 2; 0.5·i below; negated
    under bit 3."""
    nib = torch.arange(16, dtype=torch.int32)
    i = nib & 7
    pw = ((((i - 2).clamp(min=0)) >> 1) + 127 << 23).view(torch.float32)
    mag = torch.where(i >= 2, pw * (1.0 + 0.5 * (i & 1).float()), 0.5 * i.float())
    return torch.where((nib & 8) > 0, -mag, mag)


def _kernel_arithmetic(codes: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """codes [R, 16] u8 (one group a row), scales [R] u8 → [R, 32] as the
    kernel computes them."""
    lut = _signed_e2m1_table()
    nib = torch.stack([codes >> 4, codes & 0xF], -1).reshape(codes.shape[0], 32).long()
    scale = (scales.to(torch.int32) << 23).view(torch.float32)
    return (lut[nib] * scale[:, None]).to(dtype)


def test_kernel_arithmetic_bit_exact_over_every_byte_and_scale_code():
    codes, scales = _every_pair((4096, 16), (4096,))
    assert len(set(zip(codes.flatten().tolist(),
                       scales.repeat_interleave(16).tolist()))) == 256 * 256
    for dt in (torch.float32, torch.bfloat16):
        got = _kernel_arithmetic(codes, scales, dt)
        want = KV.kv_dequant_unpack_plain(codes.reshape(1, -1), scales.reshape(1, -1), dt)
        assert torch.equal(_bits(got.reshape(1, -1)), _bits(want))
    # the edges the plain version defines: scale code 0 gives ±0, 255 ±inf
    # (NaN for a zero magnitude), code 1 subnormal products kept
    f32 = KV.kv_dequant_unpack_plain(codes.reshape(1, -1), scales.reshape(1, -1)).reshape(-1, 32)
    by_code = scales
    assert bool((f32[by_code == 0] == 0).all())
    top = f32[by_code == 255]
    assert bool(top.isinf().sum() + top.isnan().sum() == top.numel()) and bool(top.isnan().any())
    low = f32[by_code == 1].abs()
    assert float(low[low > 0].min()) == 2.0**-127


class _EmulatedLaunch:
    """Stands in for the C entry ``kv_gather_dequant``: walks the kernel's
    grid, CTA by CTA, over the raw memory behind the pointers."""

    def __init__(self):
        self.calls = []

    def __call__(self, n_src, codes, scales, out, tables, n_out_chunks, chunk, total, n_tbl,
                 n_pages, out_bf16, stream):
        assert 1 <= n_src <= 2 and chunk % 16 == 0 and total % 16 == 0
        assert total <= n_out_chunks * chunk and chunk < 2**31
        dtype = torch.bfloat16 if out_bf16 else torch.float32
        width = 8 // (2 if out_bf16 else 4)  # code bytes a thread's 16-byte vector
        tiles = -(-chunk // KV.TILE)
        self.calls.append(dict(n_src=n_src, grid=(n_out_chunks * tiles, n_src), chunk=chunk,
                               total=total))
        for y in range(n_src):
            assert codes[y] % width == 0 and out[y] % 16 == 0
            for x in range(n_out_chunks * tiles):
                c, tile = divmod(x, tiles)
                out_base = c * chunk + tile * KV.TILE
                left = total - out_base
                if left <= 0:
                    continue
                n = min(KV.TILE, chunk - tile * KV.TILE, left)
                src = c
                if tables:
                    page = ctypes.c_int32.from_address(tables + 4 * (c % n_tbl)).value
                    src = (c // n_tbl) * n_pages + page
                in_base = src * chunk + tile * KV.TILE
                cb = torch.frombuffer(bytearray(ctypes.string_at(codes[y] + in_base, n)),
                                      dtype=torch.uint8)
                sb = torch.frombuffer(bytearray(ctypes.string_at(scales[y] + in_base // 16,
                                                                 n // 16)), dtype=torch.uint8)
                vals = _kernel_arithmetic(cb.reshape(-1, 16), sb, dtype).contiguous()
                ctypes.memmove(out[y] + 2 * out_base * vals.element_size(), vals.data_ptr(),
                               vals.numel() * vals.element_size())
        return 0


@pytest.fixture
def launch(monkeypatch):
    """The wrappers' card path on CPU tensors, the C entry emulated."""
    fake = _EmulatedLaunch()
    monkeypatch.setattr(KV, "_device", lambda name, t: True)
    monkeypatch.setattr(KV, "_entries", lambda: (None, fake))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


def _pool(L, n_pages, ps, H, hd, shift=0):
    return _every_pair((L, n_pages, ps, H, hd // 2), (L, n_pages, ps, H, hd // 32), shift)


def _tables(P):
    """Ragged tables of 3 slots over 7 pages: the scratch page 0 (unused
    table entries), a page read twice."""
    t = np.array([[3, 1, 6, 2, 0], [5, 0, 0, 0, 0], [4, 3, 2, 1, 0]], np.int32)[:, :P]
    return torch.from_numpy(np.ascontiguousarray(t))


@pytest.mark.parametrize("P", [1, 3])
def test_kv_gather_dequant_kv_equals_two_gathers_and_reference(P):
    """On the CPU: two plain gathers, equal to ``kv_gather_dequant`` leaf by
    leaf and to the reference's dequantize of the gathered rows.  Scale
    codes 2..254 here: XLA:CPU flushes the subnormal products of code 1 to
    zero (tests/test_torch_kernels.py) and code 255 gives ±inf or NaN."""
    rng = np.random.default_rng(31 + P)
    L, n_pages, ps, H, hd = 2, 7, 4, 2, 64
    leaves = []
    for _ in range(2):
        codes = torch.from_numpy(rng.integers(0, 256, (L, n_pages, ps, H, hd // 2), np.uint8))
        scales = torch.from_numpy(rng.integers(2, 255, (L, n_pages, ps, H, hd // 32), np.uint8))
        leaves += [codes, scales]
    tables = _tables(P)
    idx = tables.long()
    k32, v32 = KV.kv_gather_dequant_kv(*leaves, tables, torch.float32)
    kbf, vbf = KV.kv_gather_dequant_kv(*leaves, tables, torch.bfloat16)
    for (codes, scales), f32, bf in (((leaves[0], leaves[1]), k32, kbf),
                                     ((leaves[2], leaves[3]), v32, vbf)):
        assert f32.shape == (L, 3, P * ps, H, hd)
        assert torch.equal(_bits(f32), _bits(KV.kv_gather_dequant(codes, scales, tables,
                                                                  torch.float32)))
        want = np.asarray(jdequant(jnp.asarray(codes[:, idx].reshape(-1, hd // 2).numpy()),
                                   jnp.asarray(scales[:, idx].reshape(-1, hd // 32).numpy())))
        np.testing.assert_array_equal(f32.reshape(-1, hd).numpy().view(np.int32),
                                      want.view(np.int32))
        assert torch.equal(_bits(bf), _bits(f32.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="do not match"):
        KV.kv_gather_dequant_kv(*leaves[:3], leaves[3][..., :1, :], tables, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["one leaf", "k+v", "2-d", "2-d short last chunk",
                                  "2-d rows over a tile", "2-d unaligned codes"])
def test_launch_emulated_on_the_host_equals_plain(launch, form, dtype):
    """The wrappers' launches, their C entry emulated CTA by CTA over every
    (byte, scale code) pair: each form one launch, equal to the plain
    version by bit pattern."""
    before = KV.kv_dequant_unpack.launches
    L, n_pages, ps, H, hd = 2, 7, 16, 2, 128  # a page of a layer: 2048 code bytes
    if form in ("one leaf", "k+v"):
        kc, ks = _pool(L, n_pages, ps, H, hd)
        vc, vs = _pool(L, n_pages, ps, H, hd, shift=97)
        tables = _tables(3)
        idx = tables.long()
        if form == "one leaf":
            got = [KV.kv_gather_dequant(vc, vs, tables, dtype)]
            want = [(vc, vs)]
        else:
            got = KV.kv_gather_dequant_kv(kc, ks, vc, vs, tables, dtype)
            want = [(kc, ks), (vc, vs)]
        want = [KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], dtype).reshape(g.shape)
                for (c, s), g in zip(want, got)]
        assert launch.calls[-1]["grid"] == (L * 3 * 3, len(got))
        assert launch.calls[-1]["chunk"] == ps * H * hd // 2
    else:
        m, kh = {"2-d": (256, 256), "2-d short last chunk": (1000, 48),
                 "2-d rows over a tile": (5, 2 * KV.TILE + 64),
                 "2-d unaligned codes": (300, 64)}[form]
        codes, scales = _every_pair((m * kh + 1,), (m * kh // 16,), shift=5)
        codes = codes[1:] if form == "2-d unaligned codes" else codes[:-1]
        codes, scales = codes.reshape(m, kh), scales.reshape(m, kh // 16)
        got = [KV.kv_dequant_unpack(codes, scales, dtype)]
        want = [KV.kv_dequant_unpack_plain(codes, scales, dtype)]
        n, chunk, total = KV.row_chunks(m, kh)
        assert chunk % kh == 0 and (chunk <= KV.TILE or chunk == kh)
        assert (n - 1) * chunk < total <= n * chunk
    assert KV.kv_dequant_unpack.launches - before == 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(_bits(g), _bits(w))


def test_gather_pages_is_one_launch(launch):
    """The gather backend's step reads a packed pool in one B4b launch; a
    dense pool in none."""
    L, n_pages, ps, H, hd = 2, 7, 4, 2, 64
    kc, ks = _pool(L, n_pages, ps, H, hd)
    vc, vs = _pool(L, n_pages, ps, H, hd, shift=3)
    pool = {"k_codes": kc, "k_scales": ks, "v_codes": vc, "v_scales": vs}
    tables = _tables(5)
    before = KV.kv_dequant_unpack.launches
    k, v = paged_cache.gather_pages(pool, tables, torch.bfloat16)
    assert KV.kv_dequant_unpack.launches - before == 1
    for got, (c, s) in ((k, (kc, ks)), (v, (vc, vs))):
        want = KV.kv_dequant_unpack_plain(c[:, tables.long()], s[:, tables.long()],
                                          torch.bfloat16).reshape(got.shape)
        assert torch.equal(_bits(got), _bits(want))
    dense = {"k": torch.zeros((L, n_pages, ps, H, hd)), "v": torch.zeros((L, n_pages, ps, H, hd))}
    paged_cache.gather_pages(dense, tables, torch.float32)
    assert KV.kv_dequant_unpack.launches - before == 1


@pytest.mark.cuda
def test_b4b_redesign_bit_exact_on_card():
    """The kernel against its plain version run on the card, by bit pattern,
    f32 and bf16, every (byte, scale code) pair: the one-leaf and K+V
    gathers over ragged tables (the scratch page, a page read twice, P = 1
    and 5) and the 2-d form (one tile, a short last chunk, rows longer than
    a tile, unaligned codes); the K+V form in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = "cuda"
    L, n_pages, ps, H, hd = 2, 65, 16, 8, 128
    kc, ks = (t.to(dev) for t in _pool(L, n_pages, ps, H, hd))
    vc, vs = (t.to(dev) for t in _pool(L, n_pages, ps, H, hd, shift=97))
    full = torch.arange(1, n_pages, dtype=torch.int32).reshape(4, 16)
    for tables in (full, _tables(1), _tables(5)):
        tables = tables.contiguous().to(dev)
        idx = tables.long()
        for dt in (torch.float32, torch.bfloat16):
            want = [KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], dt)
                    for c, s in ((kc, ks), (vc, vs))]
            before = KV.kv_dequant_unpack.launches
            k, v = KV.kv_gather_dequant_kv(kc, ks, vc, vs, tables, dt)
            assert KV.kv_dequant_unpack.launches - before == 1
            one = KV.kv_gather_dequant(vc, vs, tables, dt)
            for g, w in ((k, want[0]), (v, want[1]), (one, want[1])):
                assert torch.equal(_bits(g), _bits(w.reshape(g.shape))), (tuple(tables.shape), dt)
    for m, kh, lead in ((4096, 256, 0), (1000, 48, 0), (5, 2 * KV.TILE + 64, 0), (300, 64, 1)):
        codes, scales = _every_pair((m * kh + lead,), (m * kh // 16,), shift=5)
        codes = codes[lead:].to(dev).reshape(m, kh)
        scales = scales.to(dev).reshape(m, kh // 16)
        for dt in (torch.float32, torch.bfloat16):
            got = KV.kv_dequant_unpack(codes, scales, dt)
            assert torch.equal(_bits(got), _bits(KV.kv_dequant_unpack_plain(codes, scales, dt))), \
                (m, kh, lead, dt)
    torch.cuda.synchronize()
