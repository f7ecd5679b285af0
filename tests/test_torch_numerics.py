"""PyTorch port vs the JAX reference: numeric formats, Hadamard, quantizers.

Inputs are drawn with numpy from a seed and fed to both packages; outputs
must agree bit for bit, except where stated: the reference's E8M0-nearest
rounds through XLA's float ``log2``, which misrounds inside a window of
±8 ulps around √2·2^k, while the port compares the mantissa with √2 and is
exact — inside that window the port matches the float64 answer and the
reference does not.  The same holds for E8M0-ceil (the backward's rule)
within 64 ulps above each power of two (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastrng as JR
from repro.core import formats as JF
from repro.core import hadamard as JH
from repro.core import quantizers as JQ
from repro_torch.core import fastrng as TR
from repro_torch.core import formats as TF
from repro_torch.core import hadamard as TH
from repro_torch.core import quantizers as TQ


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def xla_cpu_hadamard(x: torch.Tensor, g: int = 32, dim: int = -1) -> torch.Tensor:
    """The grouped Hadamard summed in the reference's order on the CPU: for
    groups of ≥ 64 rows XLA:CPU's dot runs two fused multiply-add chains,
    one over the even and one over the odd k, and adds them at the end (the
    FMAs emulated in float64, where every product is exact)."""
    x = torch.movedim(x, dim, -1)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // g, g).to(torch.float64)
    h = torch.as_tensor(TH.hadamard_matrix(g), dtype=torch.float64)
    acc = [torch.zeros(xb.shape, dtype=torch.float32) for _ in range(2)]
    for i in range(g):
        acc[i % 2] = (acc[i % 2].to(torch.float64) + xb[..., i:i + 1] * h[i]).to(torch.float32)
    return torch.movedim((acc[0] + acc[1]).reshape(x.shape).to(x.dtype), -1, dim)


def use_reference_dot_order(monkeypatch):
    """Make the port's Quartet path rotate in the reference's CPU summation
    order, so its stochastic-rounding operands carry the reference's bits (a
    one-ulp difference there can flip a rounding decision and move a
    gradient column by a grid step)."""
    import repro_torch.core.quartet as TQL

    monkeypatch.setattr(TH, "hadamard_transform", xla_cpu_hadamard)
    monkeypatch.setattr(TQL, "hadamard_transform", xla_cpu_hadamard)


def _edges():
    """Every E2M1 tie and saturation point, a few ulps either side, ±0,
    ±inf, and values far past the grid."""
    ties = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 6.0, 0.5, 1.0, 1.5, 2.0,
                     3.0, 4.0], np.float32)
    near = [(ties.view(np.int32) + d).view(np.float32) for d in (-2, -1, 0, 1, 2)]
    far = np.array([0.0, 6.5, 7.0, 100.0, 1e30, np.inf, 1e-30, 1e-45], np.float32)
    v = np.concatenate(near + [far])
    return np.concatenate([v, -v])


def test_rtn_e2m1_bit_exact_at_ties_and_saturation():
    x = np.concatenate([_edges(), np.random.default_rng(0).standard_normal(4096)
                        .astype(np.float32) * 3])
    _bits_equal(JF.rtn_e2m1(jnp.asarray(x)), TF.rtn_e2m1(torch.from_numpy(x)).numpy())


def test_nibbles_roundtrip_and_match_reference():
    grid = np.asarray(JF.MXFP4.grid, np.float32)
    q = np.random.default_rng(1).choice(grid, size=(6, 64)).astype(np.float32)
    jn = np.asarray(jax.jit(JF.e2m1_to_nibble)(jnp.asarray(q)))
    tn = TF.e2m1_to_nibble(torch.from_numpy(q))
    _bits_equal(jn, tn.numpy())
    _bits_equal(jax.jit(JF.pack_nibbles)(jnp.asarray(jn)), TF.pack_nibbles(tn).numpy())
    _bits_equal(jax.jit(JF.nibble_to_e2m1)(jnp.asarray(jn)), TF.nibble_to_e2m1(tn).numpy())
    packed = TF.pack_nibbles(tn)
    _bits_equal(jax.jit(JF.unpack_nibbles)(jnp.asarray(packed.numpy())),
                TF.unpack_nibbles(packed).numpy())


def _sqrt2_window(k_lo=-126, k_hi=127, ulps=8):
    vs = []
    for k in range(k_lo, k_hi + 1):
        b = np.float32(np.sqrt(2.0) * 2.0**k).view(np.int32)
        vs.append((b + np.arange(-ulps, ulps + 1, dtype=np.int32)).view(np.float32))
    vs = np.concatenate(vs)
    return vs[np.isfinite(vs)]


def test_round_scale_e8m0_nearest_edges():
    """Near √2·2^k the port equals the exact (float64) nearest power of two
    everywhere; the reference agrees with the port wherever its float log2
    rounds correctly, and every disagreement is a reference misround inside
    the ±8-ulp window."""
    rng = np.random.default_rng(2)
    far = np.exp2(rng.uniform(-125, 126, 4096)).astype(np.float32)
    for vs, window in ((_sqrt2_window(), True), (far, False)):
        t = TF.round_scale_e8m0(torch.from_numpy(vs)).numpy()
        j = np.asarray(JF.round_scale_e8m0(jnp.asarray(vs), "nearest"))
        exact = np.exp2(np.clip(np.round(np.log2(np.maximum(vs.astype(np.float64), 2.0**-126))),
                                -126, 127)).astype(np.float32)
        np.testing.assert_array_equal(t, exact)
        if not window:
            np.testing.assert_array_equal(t, j)
        else:
            assert np.all(j[t != j] != exact[t != j])
    # below the E8M0 floor and at it
    tiny = np.array([0.0, 1e-45, 2.0**-127, 2.0**-126, 3e-38], np.float32)
    _bits_equal(JF.round_scale_e8m0(jnp.asarray(tiny), "nearest"),
                TF.round_scale_e8m0(torch.from_numpy(tiny)).numpy())


def test_e8m0_codes_roundtrip():
    e = np.arange(-126, 128)
    s = np.exp2(e).astype(np.float32)
    jc = np.asarray(JF.scale_to_e8m0_code(jnp.asarray(s)))
    tc = TF.scale_to_e8m0_code(torch.from_numpy(s))
    _bits_equal(jc, tc.numpy())
    _bits_equal(JF.e8m0_code_to_scale(jnp.asarray(jc)), TF.e8m0_code_to_scale(tc).numpy())


def test_gaussian_optimal_clip_and_hadamard_matrix():
    assert TF.gaussian_optimal_clip("mxfp4") == JF.gaussian_optimal_clip("mxfp4")
    for g in (2, 8, 32):
        _bits_equal(JH.hadamard_matrix(g), TH.hadamard_matrix(g))


@pytest.mark.parametrize("dim", [-1, 0])
def test_hadamard_transform_matches_reference(dim):
    x = np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32)
    j = np.asarray(JH.hadamard_transform(jnp.asarray(x), g=32, axis=dim))
    t = TH.hadamard_transform(torch.from_numpy(x), g=32, dim=dim).numpy()
    # a 32-term matrix product each side, summed in each library's order
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(TH.hadamard_transform(torch.from_numpy(t), g=32, dim=dim)
                               .numpy(), x, atol=1e-5)  # involutory


@pytest.mark.parametrize("scale", [0.01, 1.0, 37.0])
def test_quest_bit_exact(scale):
    x = (np.random.default_rng(4).standard_normal((48, 128)) * scale).astype(np.float32)
    j = jax.jit(JQ.quest, static_argnums=1)(jnp.asarray(x), JF.MXFP4)
    t = TQ.quest(torch.from_numpy(x), TF.MXFP4)
    for a, b in zip(j, t):
        _bits_equal(a, b.numpy())


@pytest.mark.parametrize("block", [32, 16])
def test_kv_quantize_dequantize_bit_exact(block):
    import dataclasses

    jfmt = dataclasses.replace(JF.MXFP4, block=block)
    tfmt = dataclasses.replace(TF.MXFP4, block=block)
    x = (np.random.default_rng(5).standard_normal((3, 5, 2, 64)) * 2.3).astype(np.float32)
    x[0, 0, 0, :32] = 0.0  # an all-zero block
    j = jax.jit(JQ.kv_quantize, static_argnums=1)(jnp.asarray(x), jfmt)
    t = TQ.kv_quantize(torch.from_numpy(x), tfmt)
    _bits_equal(j.codes, t.codes.numpy())
    _bits_equal(j.scales, t.scales.numpy())
    _bits_equal(jax.jit(JQ.kv_dequantize, static_argnums=1)(j, jfmt),
                TQ.kv_dequantize(t, tfmt).numpy())


# ---------------------------------------------------------------------------
# the backward's numerics: counter-hash bits, E8M0-ceil, stochastic rounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 5, 64)])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_fastrng_bit_exact(shape, seed):
    salts = (0, 1, 4, 12)
    want = jax.jit(lambda s: [(JR.random_bits(s, shape, t), JR.uniform(s, shape, t),
                               JR.rademacher(s, shape[-1], t)) for t in salts])(jnp.uint32(seed))
    for salt, (jb, ju, jr) in zip(salts, want):
        np.testing.assert_array_equal(TR.random_bits(seed, shape, salt).numpy(),
                                      np.asarray(jb).astype(np.int64))
        _bits_equal(ju, TR.uniform(seed, shape, salt).numpy())
        _bits_equal(jr, TR.rademacher(seed, shape[-1], salt).numpy())


def _pow2_window(ulps=64):
    """raw = 2^k·(1 + j·2⁻²³) for j in 0..ulps and every k."""
    vs = [(np.float32(2.0**k).view(np.int32) + np.arange(ulps + 1, dtype=np.int32))
          .view(np.float32) for k in range(-126, 128)]
    vs = np.concatenate(vs)
    return vs[np.isfinite(vs)]


def test_round_scale_e8m0_ceil_edges():
    """Across the sweep the port equals the float64 value of
    ceil(log2(raw) − 1e-6); on random data it equals the reference bit for
    bit; every disagreement in the sweep is a reference misround (its f32
    log2 and f32 subtraction), recorded as ROADMAP C3."""
    rng = np.random.default_rng(6)
    far = np.exp2(rng.uniform(-125, 126, 4096)).astype(np.float32)
    for vs, window in ((_pow2_window(), True), (far, False)):
        t = TF.round_scale_e8m0(torch.from_numpy(vs), "ceil").numpy()
        j = np.asarray(jax.jit(lambda v: JF.round_scale_e8m0(v, "ceil"))(jnp.asarray(vs)))
        exact = np.exp2(np.clip(np.ceil(np.log2(vs.astype(np.float64)) - 1e-6),
                                -126, 127)).astype(np.float32)
        np.testing.assert_array_equal(t, exact)
        if not window:
            np.testing.assert_array_equal(t, j)
        else:
            assert np.all(j[t != j] != exact[t != j])
    tiny = np.array([0.0, 1e-45, 2.0**-127, 2.0**-126, 3e-38, 3e38], np.float32)
    _bits_equal(JF.round_scale_e8m0(jnp.asarray(tiny), "ceil"),
                TF.round_scale_e8m0(torch.from_numpy(tiny), "ceil").numpy())


def test_stochastic_round_to_grid_bit_exact():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-6.5, 6.5, 8192).astype(np.float32), _edges()])
    u = rng.random(x.shape).astype(np.float32)
    u[:64] = 0.0  # u = 0 always rounds up (p_up > 0), u → 1 down
    u[64:128] = np.float32(1.0 - 2.0**-24)
    grid = jnp.asarray(JF.MXFP4.grid_array)
    j = jax.jit(lambda a, b: JF.stochastic_round_to_grid(a, grid, b))(jnp.asarray(x),
                                                                        jnp.asarray(u))
    _bits_equal(j, TF.stochastic_round_to_grid(torch.from_numpy(x), TF.MXFP4.grid,
                                               torch.from_numpy(u)).numpy())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_sr_absmax_fast_bit_exact(scale):
    x = (np.random.default_rng(8).standard_normal((3, 40, 96)) * scale).astype(np.float32)
    x[0, 0, :32] = 0.0  # an all-zero block
    j = jax.jit(lambda a: JQ.sr_absmax_fast(a, jnp.uint32(11), JF.MXFP4, "ceil", 3))(
        jnp.asarray(x))
    t = TQ.sr_absmax_fast(torch.from_numpy(x), 11, TF.MXFP4, "ceil", 3)
    for a, b in zip(j, t):
        _bits_equal(a, b.numpy())


@pytest.mark.parametrize("dim", [-1, 0])
def test_randomized_hadamard_bit_exact(dim, monkeypatch):
    """The port's Ĥ (signs along ``dim``, then H) is the reference's: bit-exact
    when H sums in the reference's CPU order, and within a few f32 ulps in
    the port's own matrix-product order."""
    x = np.random.default_rng(9).standard_normal((96, 256)).astype(np.float32)
    signs = np.asarray(JR.rademacher(jnp.uint32(4), x.shape[dim], 11))
    j = jax.jit(lambda a, s: JH.randomized_hadamard_transform(a, s, 32, dim))(
        jnp.asarray(x), jnp.asarray(signs))
    t = TH.randomized_hadamard_transform(torch.from_numpy(x), torch.from_numpy(signs), 32, dim)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-6)
    # H is involutory and D² = I: H then the signs undo the transform
    back = TH.hadamard_transform(t, 32, dim) * torch.from_numpy(
        signs if dim == -1 else signs[:, None])
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    use_reference_dot_order(monkeypatch)
    t = TH.randomized_hadamard_transform(torch.from_numpy(x), torch.from_numpy(signs), 32, dim)
    _bits_equal(j, t.contiguous().numpy())
