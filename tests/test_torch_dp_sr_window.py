"""B2's counter window: a block of a backward operand draws the bits one
device draws at its elements.  ``fastrng``'s window and B2's plain version
against the slices of the whole tensor, bit for bit, and against the
reference's Pallas B2 (interpret mode, fed the whole operand's uniforms, as
its own tests run it); the data-parallel rank windows of the Quartet
backward (dy's rows at salt 1; the transposed xqᵀ and dyᵀ columns, whose
hashing row length is the global token count, at salts 3 and 4; the signs
ξ_B at salt 12); the index wrapping mod 2^32.  One ``cuda`` case runs the
kernel's window entry on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastrng as JR
from repro.kernels.sr_hadamard_quant import sr_hadamard_quantize as jsr
from repro_torch.core import fastrng
from repro_torch.core import quantizers as Q
from repro_torch.kernels import sr_hadamard_quant as SR


def test_fastrng_window_is_the_whole_tensors_slice():
    M, K, seed, salt = 24, 96, 77, 3
    whole = fastrng.uniform(seed, (M, K), salt)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(JR.uniform(jnp.uint32(seed),
                                                                       (M, K), salt)))
    for r0, r1 in ((0, 8), (8, 24), (5, 6)):  # row blocks
        got = fastrng.uniform(seed, (r1 - r0, K), salt, offset=r0 * K)
        assert torch.equal(got, whole[r0:r1])
    for c0, c1 in ((0, 32), (32, 96), (40, 72)):  # column blocks: row length K
        got = fastrng.uniform(seed, (M, c1 - c0), salt, offset=c0, row_len=K)
        assert torch.equal(got, whole[:, c0:c1])
    signs = fastrng.rademacher(seed, 256, salt=12)
    for r in range(4):
        assert torch.equal(fastrng.rademacher(seed, 64, salt=12, offset=64 * r),
                           signs[64 * r:64 * (r + 1)])
    # per-expert seeds keep their slices
    seeds = torch.tensor([3, 2**31 + 5])
    got = fastrng.uniform(seeds, (4, 32), salt, offset=64, row_len=64)
    for e, s in enumerate(seeds.tolist()):
        assert torch.equal(got[e], fastrng.uniform(s, (5, 64), salt)[1:, :32])
    with pytest.raises(ValueError, match="row length"):
        fastrng.uniform(seed, (2, 64), salt, row_len=32)


def test_fastrng_window_index_wraps_mod_2_32():
    """The index of element i is offset + i mod 2^32 (``fastrng.py``'s
    uint32 arithmetic): a window across the wrap continues at index 0."""
    seed = 9
    high = fastrng.random_bits(seed, (64,), 1, offset=2**32 - 32)
    assert torch.equal(high[32:], fastrng.random_bits(seed, (32,), 1))
    assert torch.equal(high[:32], fastrng.random_bits(seed, (32,), 1, offset=-32 % 2**32))


def _operand(m, k, seed=4):
    return (np.random.default_rng(seed).standard_normal((m, k)) * 1.7).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_b2_rank_windows_equal_the_one_device_operands(n):
    """A rank's blocks of the Quartet backward's operands: dy [Bl, N] rows
    of [B, N]; xqᵀ [K, Bl] columns of [K, B] (a transposed view, read in
    place); their codes and scales are the whole operand's slices, and the
    whole operand's equal the reference's Pallas B2."""
    B, K, seed = 128, 96, 1234
    Bl = B // n
    dy = _operand(B, K, 5)
    xq = _operand(B, K, 6)
    signs_k = fastrng.rademacher(seed, K, salt=11)
    signs_b = fastrng.rademacher(seed, B, salt=12)
    # dy along N: rows, the window's offset r·Bl·N
    whole = SR.sr_hadamard_quantize(torch.from_numpy(dy), signs_k, seed, salt=1)
    u = JR.uniform(jnp.uint32(seed), (B, K), 1)
    ref = jsr(jnp.asarray(dy), jnp.asarray(signs_k.numpy()), u, block_m=64, block_k=96)
    for g, w in zip(whole, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for r in range(n):
        got = SR.sr_hadamard_quantize(torch.from_numpy(dy[r * Bl:(r + 1) * Bl]), signs_k, seed,
                                      salt=1, offset=r * Bl * K)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[r * Bl:(r + 1) * Bl])
    # xqᵀ along the tokens: columns, offset r·Bl, row length B
    xt = torch.from_numpy(np.ascontiguousarray(xq.T))  # [K, B]
    whole = SR.sr_hadamard_quantize(xt, signs_b, seed, salt=3)
    u = JR.uniform(jnp.uint32(seed), (K, B), 3)
    ref = jsr(jnp.asarray(xq.T), jnp.asarray(signs_b.numpy()), u, block_m=32, block_k=128)
    for g, w in zip(whole, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for r in range(n):
        block = torch.from_numpy(xq[r * Bl:(r + 1) * Bl]).t()  # the rank's view
        sb = fastrng.rademacher(seed, Bl, salt=12, offset=r * Bl)
        assert torch.equal(sb, signs_b[r * Bl:(r + 1) * Bl])
        codes, scales = SR.sr_hadamard_quantize(block, sb, seed, salt=3, offset=r * Bl,
                                                row_len=B)
        assert torch.equal(codes, whole[0][:, r * Bl:(r + 1) * Bl])
        assert torch.equal(scales, whole[1][:, r * Bl // 32:(r + 1) * Bl // 32])


def test_plain_path_sr_window_equals_the_slice():
    """The plain path's SR quantizer (``sr_absmax_fast``) through the same
    window: a column block of ¾·(Ĥ xᵀ) quantizes to the whole one's slice."""
    x = torch.from_numpy(_operand(64, 128, 8))
    whole = Q.sr_absmax_fast(x, 31, salt=4)
    got = Q.sr_absmax_fast(x[:, 32:96], 31, salt=4, offset=32, row_len=128)
    assert torch.equal(got.values, whole.values[:, 32:96])
    assert torch.equal(got.codes, whole.codes[:, 32:96])
    assert torch.equal(got.scales, whole.scales[:, 1:3])


def test_b2_window_rejects_a_row_shorter_than_the_block():
    x, signs = torch.zeros((4, 64)), torch.ones(64)
    with pytest.raises(ValueError, match="row length"):
        SR.sr_hadamard_quantize(x, signs, 0, salt=1, row_len=63)


@pytest.mark.cuda
def test_b2_window_entry_equals_plain_on_card():
    """The kernel's window entry against its plain version on the card, at
    rank blocks of a transposed [K, Bp] operand and a row-major dy, on the
    vector and the tile body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    B, K, n = 1024, 256, 4
    Bl = B // n
    x = torch.randn((B, K), generator=gen, device=dev)
    for r in range(n):
        sb = fastrng.rademacher(7, Bl, salt=12, offset=r * Bl, device=dev)
        blk = x[r * Bl:(r + 1) * Bl]
        for view, kw in ((blk.t(), {"offset": r * Bl, "row_len": B}),
                         (blk, {"offset": r * Bl * K}),
                         (x[r * Bl:(r + 1) * Bl, 3:3 + 224], {"offset": r * Bl * 224})):
            s = sb if view.shape[1] == Bl else fastrng.rademacher(7, view.shape[1], 11,
                                                                  device=dev)
            got = SR.sr_hadamard_quantize(view, s, 99, salt=3, **kw)
            want = SR.sr_hadamard_quantize_plain(view, s, 99, salt=3, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
