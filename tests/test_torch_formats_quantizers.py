"""PyTorch port vs the JAX reference: the paper's formats and quantizers.

The same seeded numpy inputs go through ``repro.core`` (eagerly, on the
CPU) and ``repro_torch.core``:

* every format's grid, block, scale dtype and bit width, ``get_format``,
  QuEST's Gaussian clip for every format with a grid, and RTN-PMA's γ;
* ``quantize_scale``: E8M0 in all three modes, E4M3 (NVFP4) with the
  reference's NaN above 464 and 0 at or below 2⁻¹⁰ (ROADMAP C7), fp32;
  ``rtn_to_grid`` on every grid (midpoint ties go to the lower index, NaN to
  the top); ``rtn_e2m1`` of ±∞ and NaN;
* ``round_scale_e8m0(mode="floor")``: the port equals the float64 value of
  ``floor(log2 s + 1e-6)`` everywhere, the reference wherever its f32
  ``log2`` rounds correctly, and every disagreement is a reference misround
  (ROADMAP C8);
* threefry ``split``, shaped ``bits``/``uniform``, ``bernoulli`` and
  ``rademacher`` bit for bit against ``jax.random``;
* every quantizer (RTN-AbsMax, SR-AbsMax, QuEST, RTN-PMA, the fast SR) on
  every format, bit for bit in values, codes (MXFP8's and INT8's wrapped
  int8 codes included), scales and masks, NaN positions included.  Two
  reference facts bound "bit for bit": XLA:CPU flushes subnormal results
  to zero (a port value below 2⁻¹²⁶ may be ±0 there, sign kept; ROADMAP
  C1), and it sums a QuEST row of more than 32 elements in an order of its
  own, so the per-tensor formats' QuEST runs on rows of 32 (up to 32 it
  adds the squares one after another, as the port does);
* ``lsq``'s output and gradients against ``jax.grad`` of the reference's
  custom VJP (the step's gradient is a sum: rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import quantizers as JQ
from repro_torch.core import formats as TF
from repro_torch.core import quantizers as TQ
from repro_torch.core import threefry

FORMATS = [n for n in JF.FORMATS if n != "bf16"]
QUANTIZERS = ["rtn_absmax", "sr_absmax", "quest", "rtn_absmax_pma", "sr_absmax_fast"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small ops, several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(want, got, name=""):
    """Bit for bit (NaN at the same positions, any payload), but a port
    value below 2⁻¹²⁶ may be ±0 (same sign) in the reference: XLA:CPU
    flushes subnormal results."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (name, want.shape, want.dtype,
                                                                 got.shape, got.dtype)
    if want.dtype == np.float32:
        diff = (want.view(np.uint32) != got.view(np.uint32)) & ~(np.isnan(want) & np.isnan(got))
        flushed = ((want == 0) & (got != 0) & (np.abs(got) < 2.0**-126)
                   & (np.signbit(want) == np.signbit(got)))
        bad = diff & ~flushed
    else:
        bad = want != got
    assert not bad.any(), (name, int(bad.sum()), want[bad][:6], got[bad][:6])


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JF.FORMATS))
def test_format_matches_reference(name):
    j, t = JF.get_format(name), TF.get_format(name)
    assert (t.name, t.grid, t.block, t.scale_dtype, t.bits) == (j.name, j.grid, j.block,
                                                                j.scale_dtype, j.bits)
    _bits_equal(j.grid_array, t.grid_array, name)
    assert t.num_levels == j.num_levels
    if t.grid:
        assert t.max_value == j.max_value
        assert TF.gaussian_optimal_clip(name) == JF.gaussian_optimal_clip(name)
        assert TQ.pma_gamma(t) == JQ.pma_gamma(j)
    with pytest.raises(ValueError):
        TF.get_format(name + "x")


def _e4m3_sweep():
    rng = np.random.default_rng(0)
    edges = np.array([0.0, 2.0**-10, 2.0**-9, 2.0**-6, 448.0, 456.0, 464.0, 480.0, 512.0,
                      np.inf, np.nan, 2.0**-126, 1e-45, 3e38], np.float32)
    near = [(edges[:9].view(np.int32) + d).view(np.float32) for d in (-2, -1, 1, 2)]
    spread = np.exp2(rng.uniform(-140, 127, 20000)).astype(np.float32)
    return np.concatenate([edges, *near, spread, rng.uniform(0, 600, 20000).astype(np.float32)])


@pytest.mark.parametrize("name", ["mxfp4", "nvfp4", "int8"])
@pytest.mark.parametrize("mode", ["nearest", "ceil", "floor"])
def test_quantize_scale_matches_reference(name, mode):
    """E8M0 (each mode), E4M3 (NaN past 464, 0 at 2⁻¹⁰ and below) and fp32
    scales, bit for bit (positive scales away from E8M0's misround windows,
    which the edge tests below sweep)."""
    rng = np.random.default_rng(1)
    vs = np.exp2(rng.uniform(-125, 126, 8192)).astype(np.float32)
    if name == "nvfp4":
        vs = _e4m3_sweep()
    want = np.asarray(JF.quantize_scale(jnp.asarray(vs), JF.get_format(name), mode))
    got = TF.quantize_scale(torch.from_numpy(vs), TF.get_format(name), mode).numpy()
    _bits_equal(want, got, name)
    if name == "nvfp4":
        assert np.isnan(got[vs > 464]).all() and not np.isnan(got[vs <= 464]).any()
        assert (got[vs <= 2.0**-10] == 0).all()


def _pow2_below(ulps=64):
    """2^k·(1 − j·2⁻²⁴) for j in 0..ulps, every k: the floor rule's edges."""
    vs = [(np.float32(2.0**k).view(np.int32) - np.arange(ulps + 1, dtype=np.int32))
          .view(np.float32) for k in range(-125, 128)]
    return np.concatenate(vs)


def test_round_scale_e8m0_floor_edges():
    """Across the sweep the port equals the float64 value of
    floor(log2(raw) + 1e-6) (the 11 floats below each power of two round up
    to it, as the formula says); on random data it equals the reference bit
    for bit; every disagreement in the sweep is a reference misround (its
    f32 log2 and f32 addition), recorded as ROADMAP C8."""
    rng = np.random.default_rng(6)
    far = np.exp2(rng.uniform(-125, 126, 4096)).astype(np.float32)
    for vs, window in ((_pow2_below(), True), (far, False)):
        t = TF.round_scale_e8m0(torch.from_numpy(vs), "floor").numpy()
        j = np.asarray(JF.round_scale_e8m0(jnp.asarray(vs), "floor"))
        exact = np.exp2(np.clip(np.floor(np.log2(vs.astype(np.float64)) + 1e-6),
                                -126, 127)).astype(np.float32)
        np.testing.assert_array_equal(t, exact)
        if not window:
            np.testing.assert_array_equal(t, j)
        else:
            assert np.all(j[t != j] != exact[t != j])
            assert (t != j).any()  # the window holds misrounds
    four_below = np.array([np.nextafter(np.float32(4.0), np.float32(0.0))], np.float32)
    assert float(TF.round_scale_e8m0(torch.from_numpy(four_below), "floor")) == 4.0
    tiny = np.array([0.0, 1e-45, 2.0**-127, 2.0**-126, 3e-38, 3e38], np.float32)
    _bits_equal(JF.round_scale_e8m0(jnp.asarray(tiny), "floor"),
                TF.round_scale_e8m0(torch.from_numpy(tiny), "floor").numpy())
    with pytest.raises(ValueError):
        TF.round_scale_e8m0(torch.from_numpy(tiny), "up")


@pytest.mark.parametrize("name", FORMATS)
def test_rtn_to_grid_matches_reference(name):
    """Every grid: random values, every midpoint (a tie: the lower index)
    and the ulps beside it, ±0, values past the grid, ±∞ and NaN."""
    grid = JF.get_format(name).grid_array
    mids = ((grid[1:] + grid[:-1]) / np.float32(2)).astype(np.float32)
    near = [(mids.view(np.int32) + d).view(np.float32) for d in (-1, 0, 1)]
    top = grid[-1]
    rng = np.random.default_rng(2)
    x = np.concatenate([*near, rng.uniform(-1.2 * top, 1.2 * top, 4096).astype(np.float32),
                        np.array([0.0, -0.0, 2 * top, -2 * top, np.inf, -np.inf, np.nan],
                                 np.float32)])
    _bits_equal(JF.rtn_to_grid(jnp.asarray(x), jnp.asarray(grid)),
                TF.rtn_to_grid(torch.from_numpy(x), TF.get_format(name).grid).numpy(), name)


def test_rtn_e2m1_infinities_and_nan():
    """±∞ saturate to ±6 and NaN becomes −0, as the native cast (a zero
    NVFP4 scale's x/0 and 0/0)."""
    x = np.array([np.inf, -np.inf, np.nan, -np.nan, 1e30, -1e30, 0.0, -0.0], np.float32)
    _bits_equal(JF.rtn_e2m1(jnp.asarray(x)), TF.rtn_e2m1(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_threefry_split_and_shaped_draws(seed):
    key, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 7)),
                                  np.array(threefry.split(tkey, 7), np.uint32))
    ka, _ = jax.random.split(key)
    ta, _ = threefry.split(tkey)
    np.testing.assert_array_equal(np.asarray(jax.random.split(ka, 3)),
                                  np.array(threefry.split(ta, 3), np.uint32))
    for shape in [(2, 3), (3, 5, 16)]:
        np.testing.assert_array_equal(np.asarray(jax.random.bits(key, shape)),
                                      threefry.random_bits(tkey, shape, "cpu").numpy()
                                      .astype(np.uint32))
        _bits_equal(jax.random.uniform(key, shape, jnp.float32),
                    threefry.uniform(tkey, shape, "cpu").numpy())
        _bits_equal(jax.random.rademacher(key, shape, jnp.float32),
                    threefry.rademacher(tkey, shape, "cpu").numpy())
        np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(key, 0.3, shape)),
                                      threefry.bernoulli(tkey, 0.3, shape, "cpu").numpy())
    # a shaped draw is the flat draw reshaped
    assert torch.equal(threefry.random_bits(tkey, (2, 3), "cpu"),
                       threefry.random_bits(tkey, 6, "cpu").reshape(2, 3))


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


def _edge_rows(name: str, k: int) -> np.ndarray:
    """Rows of k: a zero row; rows whose blocks' absmax/max sits around
    2⁻¹⁰ and around 464 (NVFP4's E4M3 scale underflows to 0 and overflows
    to NaN there); a row of grid midpoints (ties) beside the grid's max, so
    the scale is 1."""
    fmt = JF.get_format(name)
    rng = np.random.default_rng(3)
    signs = np.where(rng.random(k) < 0.5, -1.0, 1.0)
    rows = [np.zeros(k)]
    for s in (2.0**-10 * 0.999, 2.0**-10, 2.0**-10 * 1.5, 448.0, 464.0, 465.0, 500.0):
        r = rng.uniform(-1, 1, k)
        r[:: max(fmt.block, 1) or k] = 1.0
        rows.append(signs * np.abs(r) * s * fmt.max_value)
    grid = fmt.grid_array
    mids = (grid[1:] + grid[:-1]) / 2
    block = fmt.block or k
    tie = np.resize(mids, k)
    tie[::block] = fmt.max_value
    rows.append(tie)
    return np.stack(rows).astype(np.float32)


def _case(name: str, quantizer: str) -> np.ndarray:
    fmt = JF.get_format(name)
    k = 32 if (quantizer == "quest" and fmt.block == 0) else 128
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, k)) * np.exp2(rng.integers(-8, 8, (24, 1)))
    return np.concatenate([x.astype(np.float32), _edge_rows(name, k)])


def _quantize(pkg: str, quantizer: str, x, name: str):
    if pkg == "jax":
        fmt, arr = JF.get_format(name), jnp.asarray(x)
        key, seed = jax.random.PRNGKey(3), jnp.uint32(5)
        Q = JQ
    else:
        fmt, arr = TF.get_format(name), torch.from_numpy(x)
        key, seed = threefry.prng_key(3), 5
        Q = TQ
    if quantizer == "sr_absmax":
        return Q.sr_absmax(arr, key, fmt)
    if quantizer == "sr_absmax_fast":
        return Q.sr_absmax_fast(arr, seed, fmt, "ceil", 2)
    return getattr(Q, quantizer)(arr, fmt)


@pytest.mark.parametrize("quantizer", QUANTIZERS)
@pytest.mark.parametrize("name", FORMATS)
def test_quantizer_matches_reference(name, quantizer):
    x = _case(name, quantizer)
    want = _quantize("jax", quantizer, x, name)
    got = _quantize("torch", quantizer, x, name)
    for field, w, g in zip(want._fields, want, got):
        _bits_equal(w, g.numpy(), f"{name}/{quantizer}/{field}")
    values, codes = got.values.numpy(), got.codes.numpy()
    if name == "nvfp4" and quantizer != "quest":
        # the E4M3 scale of absmax/6 past 464 is NaN: its blocks come out NaN
        assert np.isnan(values).any()
    if JF.get_format(name).max_value > 63:
        # grid indices past 127 wrap to negative int8 codes, as stored there
        assert ((codes < 0) & (values > 0)).any()


@pytest.mark.parametrize("mode", ["nearest", "floor"])
@pytest.mark.parametrize("name", ["mxfp4", "mxfp8"])
def test_absmax_scale_modes_match_reference(name, mode):
    """RTN- and SR-AbsMax with the other E8M0 modes, on random rows."""
    x = np.random.default_rng(5).standard_normal((32, 128)).astype(np.float32)
    jf, tf = JF.get_format(name), TF.get_format(name)
    for want, got in ((JQ.rtn_absmax(jnp.asarray(x), jf, mode),
                       TQ.rtn_absmax(torch.from_numpy(x), tf, mode)),
                      (JQ.sr_absmax(jnp.asarray(x), jax.random.PRNGKey(9), jf, mode),
                       TQ.sr_absmax(torch.from_numpy(x), threefry.prng_key(9), tf, mode))):
        for field, w, g in zip(want._fields, want, got):
            _bits_equal(w, g.numpy(), f"{name}/{mode}/{field}")


def test_lsq_forward_and_gradients_match_reference():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 32)) * 3).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    step = np.float32(0.4)

    def jloss(a, s):
        return jnp.sum(JQ.lsq(a, s, JF.INT4) * r)

    jy = np.asarray(JQ.lsq(jnp.asarray(x), jnp.asarray(step), JF.INT4))
    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(step))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.tensor(step).requires_grad_()
    y = TQ.lsq(xt, st, TF.INT4)
    dx, ds = torch.autograd.grad((y * torch.from_numpy(r)).sum(), [xt, st])
    _bits_equal(jy, y.detach().numpy())
    _bits_equal(jdx, dx.numpy())
    assert ds.shape == st.shape
    np.testing.assert_allclose(float(ds), float(jds), rtol=1e-5)
    assert 0 < float((np.abs(x / step) > 7).mean()) < 1  # both sides of the clip
