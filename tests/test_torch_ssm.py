"""The SSM family (Mamba1, falcon-mamba-7b reduced): the port against the
reference on the CPU.

One reference init crosses over leaf by leaf (``params_from_jax``, the f32
``A_log`` and ``D`` included); both packages run a Mamba1 block, the whole
model, and the serving steps (a prefill chunk, then single-token decodes
over the ``(conv, h)`` cache).

Which ops differ, on equal inputs (XLA:CPU jitted against PyTorch's CPU
kernels, measured on these shapes): the causal conv's taps (XLA contracts
them into FMAs, ≤ 1e-6), the scan's a·h + bx (XLA fuses it into one FMA;
the port rounds the product and the sum, as the card does, so card = CPU:
≤ 5e-7 over 16 steps), softplus (≤ 2.4e-7), silu (≤ 1e-6), exp (1 ulp)
and the einsum over N (its own order, ≤ 2e-6).  None is amplified on
these seeds (QuEST rounds no decision otherwise), so the tolerances are the
model's: logits within 2e-5 and the state within 1e-5 of max|ref|.  The
port's chunked prefill and its whole forward decompose the same recurrence
in the same order; their projections run at other row counts, so the
logits agree within 1e-5, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.models import ssm as JS
from repro.train import serve as JSV
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import build_model
from repro_torch.models import ssm as S
from repro_torch.models.transformer import layer_slice
from repro_torch.train import serve as SV

ARCH = "falcon-mamba-7b"
TOKENS = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype):
    jcfg = jget_reduced(ARCH, dtype=dtype)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tcfg = get_reduced_config(ARCH, dtype=dtype)
    return jm, jp, build_model(tcfg), params_from_jax(jax.device_get(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, frac):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1.0))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{path}.{n}").items()}
    return {path: tree}


def test_init_tree_matches_reference(f32_pair):
    """The port's own init: the reference's paths, shapes and dtypes."""
    _, jp, tm, _ = f32_pair
    tp = init_params(tm.cfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: (np.shape(v), str(np.asarray(v).dtype)) for k, v in _flat(jax.device_get(jp)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(tp).items()}
    assert got == want
    np.testing.assert_array_equal(tp["layers"]["D"].numpy(), np.ones((2, 256), np.float32))
    np.testing.assert_allclose(tp["layers"]["A_log"].numpy(), np.asarray(jp["layers"]["A_log"]),
                               rtol=1e-7)


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_mamba1_block_matches_reference(f32_pair, method):
    jm, jp, tm, tp = f32_pair
    cfg = tm.cfg
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"])
    want, _, _ = jax.jit(lambda p, x: JS.mamba1_block(
        p, x, None, jnp.uint32(77), jm.cfg, None, None, method))(jlayer, jnp.asarray(x))
    with torch.no_grad():
        got, aux = S.mamba1_block(layer_slice(tp["layers"], 0), torch.from_numpy(x), None, 77,
                                  cfg, None, method)
    assert aux == 0.0
    _close(got, want, 1e-5)


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_model_logits_match_reference(f32_pair, method):
    jm, jp, tm, tp = f32_pair
    want = jax.jit(lambda p, t: jm.forward(p, t, jnp.uint32(0), method=method)[0])(
        jp, jnp.asarray(TOKENS))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def _steps_ref(jm, jp, method):
    chunk = jax.jit(JSV.make_chunk_prefill_step(jm, method=method))
    dec = jax.jit(JSV.make_decode_step(jm, method=method))
    cache = JSV.init_cache(jm, 2, 32)
    logits, cache, pos = chunk(jp, jnp.asarray(TOKENS[:, :8]), jnp.zeros((2,), jnp.int32), cache)
    out = [logits]
    for t in range(8, 12):
        logits, cache, pos = dec(jp, jnp.asarray(TOKENS[:, t:t + 1]), pos, cache)
        out.append(logits)
    return out, cache


def _steps_port(tm, tp, method):
    chunk = SV.make_chunk_prefill_step(tm, method=method)
    dec = SV.make_decode_step(tm, method=method)
    cache = SV.init_cache(tm, 2, 32, "cpu")
    logits, cache, pos = chunk(tp, torch.from_numpy(TOKENS[:, :8]),
                               torch.zeros((2,), dtype=torch.int32), cache)
    out = [logits]
    for t in range(8, 12):
        logits, cache, pos = dec(tp, torch.from_numpy(TOKENS[:, t:t + 1]), pos, cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_cache_steps_match_reference(f32_pair, dtype, method):
    """A prefill chunk of 8 then 4 decodes over the (conv, h) cache: every
    step's logits and the final state.  In bf16 the steps cast every
    floating leaf to bf16 first, ``A_log`` and ``D`` too, on both sides."""
    jm, jp, tm, tp = f32_pair if dtype == "float32" else _pair(dtype)
    want, jcache = _steps_ref(jm, jp, method)
    got, cache = _steps_port(tm, tp, method)
    assert cache[0].dtype == getattr(torch, dtype) and cache[1].dtype == torch.float32
    assert cache[0].shape == (2, 2, 3, 256) and cache[1].shape == (2, 2, 256, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=2e-5)
    _close(cache[0], jcache[0], 1e-5)
    _close(cache[1], jcache[1], 1e-5)


def test_cast_params_makes_a_log_and_d_bf16(f32_pair):
    _, _, _, tp = f32_pair
    cast = SV.cast_params(tp, torch.bfloat16)
    assert cast["layers"]["A_log"].dtype == torch.bfloat16
    assert cast["layers"]["D"].dtype == torch.bfloat16
    same = SV.cast_params(cast, torch.bfloat16)
    assert same["layers"]["in_proj"]["w"] is cast["layers"]["in_proj"]["w"]


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_chunked_prefill_matches_whole_forward(f32_pair, method):
    """The port's chunk + decodes against its own teacher-forced forward."""
    _, _, tm, tp = f32_pair
    got, _ = _steps_port(tm, tp, method)
    with torch.no_grad():
        whole, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    for i, g in enumerate(got):
        _close(g, whole[:, 7 + i], 1e-5)


def test_selective_scan_rounds_product_and_sum():
    """h_t = a_t·h + bx_t with the product and the sum each rounded to f32
    (no FMA), as an explicit f32 loop computes it."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, (2, 9, 4, 3)).astype(np.float32)
    bx = rng.standard_normal((2, 9, 4, 3)).astype(np.float32)
    h = rng.standard_normal((2, 4, 3)).astype(np.float32)
    got = S.selective_scan(torch.from_numpy(h), torch.from_numpy(a), torch.from_numpy(bx))
    want = []
    for t in range(9):
        h = (a[:, t] * h).astype(np.float32) + bx[:, t]
        want.append(h)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
