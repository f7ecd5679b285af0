"""Mamba2 (the SSD chunked form, zamba2-7b reduced): the port against the
reference on the CPU.

``ssd_chunk_scan`` takes chunks of ``min(chunk, S)`` halved until they
divide S, as the reference's ``_ssd_chunk_scan`` does, and loops over the
chunks.  Which ops differ on equal inputs (XLA:CPU jitted against
PyTorch's CPU kernels, measured on these shapes): ``cumsum`` over a chunk
(neither library sums in sequence, and their orders differ: ≤ 6e-5 on
values of ~100, a few ulps), and the einsums' contraction orders.  The
exponent turns a cumsum ulp into a relative error of the decay, so the
scan's y agrees within 2e-5 of max |ref| (measured ≤ 5.4e-6) and its state
within 1e-5 (≤ 1e-6).  A block's output agrees within 2e-5 of max |ref|
and its state within 1e-5, in f32 and bf16 (the serving steps' cast:
``A_log``, ``dt_bias`` and ``D`` bf16 too), where a bf16 output element may instead be up to one
bf16 step at max |ref| from the reference's (an f32 difference flips the
rounding of the block's update before the residual add; fewer than 0.1% of
the elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.models import ssm as JS
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as S
from repro_torch.models.transformer import layer_slice
from repro_torch.train.serve import cast_params

ARCH = "zamba2-7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, frac):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1.0))


def _scan_inputs(S_, seed=0, B=2, nh=8, hd=32, N=16):
    rng = np.random.default_rng(seed + S_)
    xh = rng.standard_normal((B, S_, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, nh)))).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, nh)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S_, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, nh, hd, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("S_", [1, 7, 64, 96])
def test_ssd_chunk_scan_matches_reference(S_):
    """Chunk 32: one chunk of S (1, 7), two or three of 32 (64, 96)."""
    a = _scan_inputs(S_)
    jy, jh = jax.jit(lambda *x: JS._ssd_chunk_scan(*x, 32))(*a)
    ty, th = S.ssd_chunk_scan(*(torch.from_numpy(x) for x in a), 32)
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy, 2e-5)
    _close(th, jh, 1e-5)


def test_ssd_chunk_halving_rule():
    """min(chunk, S) halved until it divides S: S = 96 at chunk 64 runs
    chunks of 32 (the same bits as chunk 32), S = 7 at chunk 4 chunks of 1
    (the same bits as chunk 1); the reference agrees."""
    for S_, chunk, same in ((96, 64, 32), (7, 4, 1)):
        a = [torch.from_numpy(x) for x in _scan_inputs(S_, seed=3)]
        y, h = S.ssd_chunk_scan(*a, chunk)
        y2, h2 = S.ssd_chunk_scan(*a, same)
        assert torch.equal(y, y2) and torch.equal(h, h2)
        jy, jh = jax.jit(lambda *x: JS._ssd_chunk_scan(*x, chunk))(*(x.numpy() for x in a))
        _close(y, jy, 2e-5)
        _close(h, jh, 1e-5)


@pytest.fixture(scope="module")
def layer():
    jcfg = jget_reduced(ARCH, dtype="float32")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(2))
    tcfg = get_reduced_config(ARCH, dtype="float32")
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    # nonzero biases, so that dt_bias and conv_b take part
    rng = np.random.default_rng(5)
    jl = jax.tree.map(lambda a: a[0], jp["mamba_layers"])
    for k, s in (("dt_bias", 0.5), ("conv_b", 0.1)):
        v = (rng.standard_normal(jl[k].shape) * s).astype(np.float32)
        jl[k] = jnp.asarray(v)
    tl = layer_slice(tp["mamba_layers"], 0)
    tl = {**tl, "dt_bias": torch.from_numpy(np.array(jl["dt_bias"])),
          "conv_b": torch.from_numpy(np.array(jl["conv_b"]))}
    return jcfg, tcfg, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["no cache", "decode", "chunk"])
def test_mamba2_block_matches_reference(layer, dtype, form):
    """The block without a cache over 16 tokens, and from a random cache as
    a decode step (S = 1) and as a chunk (S = 8): output within 2e-5 and
    the new state within 1e-5 of max |ref| (method bf16: plain products)."""
    import dataclasses

    jcfg, tcfg, jl, tl = layer
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jl = jax.tree.map(lambda a: a.astype(jdt), jl)
    tl = cast_params(tl, tdt)
    rng = np.random.default_rng(7)
    S_ = {"no cache": 16, "decode": 1, "chunk": 8}[form]
    x = rng.standard_normal((2, S_, tcfg.d_model)).astype(np.float32)
    cache = jcache = None
    if form != "no cache":
        (cs, cdt), (hs, _) = S.mamba2_cache_spec(tcfg, 2)
        conv = (rng.standard_normal(cs) * 0.5).astype(np.float32)
        h = (rng.standard_normal(hs) * 0.5).astype(np.float32)
        # copies: the port writes its cache in place, and a jax array may
        # alias a numpy buffer while the jitted reference still reads it
        cache = (torch.from_numpy(conv.copy()).to(cdt), torch.from_numpy(h.copy()))
        jcache = (jnp.asarray(conv).astype(jdt), jnp.asarray(h))
    want, jnew, _ = jax.jit(lambda p, x, c: JS.mamba2_block(
        p, x, None, jnp.uint32(9), jcfg, c, None, "bf16"))(jl, jnp.asarray(x).astype(jdt), jcache)
    with torch.no_grad():
        got, aux = S.mamba2_block(tl, torch.from_numpy(x).to(tdt), None, 9, tcfg, cache, "bf16")
    assert aux == 0.0 and got.dtype == tdt
    if dtype == "float32":
        _close(got, want, 2e-5)
    else:  # bf16: an f32 difference may flip a rounding of the update or the sum
        g, w = _np(got), _np(want)
        far = np.abs(g - w) > 2e-5 * max(np.abs(w).max(), 1.0)
        step = 2.0 ** (np.ceil(np.log2(np.abs(w).max())) - 8)  # bf16's step at max |ref|
        assert far.mean() < 1e-3 and np.abs(g - w).max() <= step
    if cache is not None:
        assert cache[0].dtype == tdt and cache[1].dtype == torch.float32
        _close(cache[0], jnew[0], 1e-5)
        _close(cache[1], jnew[1], 1e-5)


def test_mamba2_cache_spec_matches_reference():
    for B in (1, 3):
        want = JS.mamba2_cache_spec(jget_reduced(ARCH), B)
        got = S.mamba2_cache_spec(get_reduced_config(ARCH), B)
        assert [(tuple(s), str(d).split(".")[-1]) for s, d in got] == \
            [(tuple(w.shape), str(w.dtype)) for w in want]
