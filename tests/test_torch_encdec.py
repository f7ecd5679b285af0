"""The enc-dec family (whisper-tiny reduced: 2 encoder and 2 decoder layers,
d 64, LayerNorm, absolute positions, a 64-frame source): the port against
the reference on the CPU.

One reference init crosses over leaf by leaf (``params_from_jax``:
``encoder`` and ``decoder`` stacks with their layernorms' scales and
biases and every dense bias).  ``layernorm`` sums both means in rmsnorm's
fixed pairwise order and takes 1/√ in float64, so it lies within a few
f32 ulps of the reference's ``jnp.mean``s; ``sinusoidal_positions`` is the
reference's numpy float64 computation rounded once, bit for bit.  The
encoder, the cross-KV encode, the teacher-forced decoder (under QuEST and
the plain bf16 products) and the serving steps (a ``build_cross`` prefill
chunk, then decodes reading the cached cross-KV) agree with the
reference's within 2e-5 of max |ref| (f32).  Inputs are numpy draws from a
seed handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.train import serve as JSV
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import build_model
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models.registry import cache_leaves
from repro_torch.train import serve as SV

ARCH = "whisper-tiny"
RNG = np.random.default_rng(5)
TOKENS = RNG.integers(0, 512, (2, 12)).astype(np.int32)
SOURCE = RNG.standard_normal((2, 64, 64)).astype(np.float32)


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


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_reduced(ARCH, dtype="float32")
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))  # the eager init, compiled
    tcfg = get_reduced_config(ARCH, dtype="float32")
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    _perturb_biases(jp, tp, np.random.default_rng(9))  # nonzero biases, so they are compared
    return jm, jp, build_model(tcfg), tp


def _perturb_biases(jp, tp, rng):
    """Every bias leaf (dense ``b``, layernorm ``bias``) set to the same
    small numpy draw on both sides."""
    def walk(j, t):
        for k in list(t):
            if isinstance(t[k], dict):
                walk(j[k], t[k])
            elif k in ("b", "bias"):
                v = (0.05 * rng.standard_normal(tuple(t[k].shape))).astype(np.float32)
                t[k].copy_(torch.from_numpy(v))
                j[k] = jnp.asarray(v)
    walk(jp, tp)


def test_configs_and_n_params():
    """The published widths; ``n_params`` is the reference's formula (the
    decoder's self-attention and MLP only)."""
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in ("num_layers", "encoder_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "mlp", "use_bias", "norm", "pos_embed",
              "tie_embeddings", "max_source_len", "attn_kv_chunk"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_params() == jcfg.n_params() == 7_077_888
    assert cfg.n_params(non_embedding=False) == jcfg.n_params(non_embedding=False) == 26_994_048
    assert get_reduced_config(ARCH).n_params() == jget_reduced(ARCH).n_params()


@pytest.mark.parametrize("n,d", [(64, 64), (1500, 384), (4096, 384), (77, 10)])
def test_sinusoidal_positions_bit_for_bit(n, d):
    want = np.asarray(JL.sinusoidal_positions(n, d))
    got = L.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert L.sinusoidal_positions(n, d) is got  # built once


@pytest.mark.parametrize("d", [64, 384, 100])
def test_layernorm_matches_reference(d):
    """f32 within 4 ulps-worth of the row's scale; bf16 within one bf16
    step; a row's bits do not depend on the call's row count."""
    rng = np.random.default_rng(d)
    x = ((rng.standard_normal((64, d)) + 3 * rng.standard_normal((64, 1)))
         * np.exp2(rng.integers(-6, 7, (64, 1)))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    want = np.asarray(JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), 1e-5))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = L.layernorm(tp, torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = np.asarray(JL.layernorm({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                                 jnp.asarray(x, jnp.bfloat16), 1e-5), np.float32)
    gb = L.layernorm({k: v.to(torch.bfloat16) for k, v in tp.items()}, xb, 1e-5)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), wb, rtol=2**-7, atol=2**-7)
    rows = torch.cat([L.layernorm(tp, torch.from_numpy(x[i:i + 1]), 1e-5) for i in range(4)])
    assert torch.equal(rows, got[:4])


def test_init_tree_matches_reference(pair):
    jm, jp, tm, _ = pair
    tp = init_params(tm.cfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items() for k, v in flat(t, f"{path}.{n}").items()}
        return {path: (tuple(np.shape(tree)), str(np.asarray(tree).dtype)
                       if not isinstance(tree, torch.Tensor) else str(tree.dtype).split(".")[-1])}

    assert flat(tp) == flat(jax.device_get(jp))


def test_params_from_jax_checks_every_leaf(pair):
    _, jp, tm, _ = pair
    tree = jax.device_get(jp)
    dec = tree["decoder"]["layers"]
    bad = {**tree, "decoder": {**tree["decoder"], "layers": {
        **dec, "cross_attn": {**dec["cross_attn"], "wk": {
            "w": np.asarray(dec["cross_attn"]["wk"]["w"])[:, :, :8],
            "b": dec["cross_attn"]["wk"]["b"]}}}}}
    with pytest.raises(ValueError, match="decoder.layers.cross_attn.wk.w"):
        params_from_jax(bad, tm.cfg, "cpu")
    extra = {**tree, "encoder": {**tree["encoder"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="encoder.stray"):
        params_from_jax(extra, tm.cfg, "cpu")


def test_encode_and_cross_kv_match_reference(pair):
    """bf16 products (QuEST reaches the encoder in the teacher-forced test)."""
    jm, jp, tm, tp = pair
    method = "bf16"
    cfg = tm.cfg
    jcfg = jm.cfg
    want = jax.jit(lambda p, s: JE.encode(p, s, jcfg, jnp.uint32(7), method))(
        jp, jnp.asarray(SOURCE))
    jk, jv = jax.jit(lambda p, s: JE.encode_cross_kv(p, s, jcfg, jnp.uint32(2**32 - 3),
                                                     method))(jp, jnp.asarray(SOURCE))
    with torch.no_grad():
        got = E.encode(tp, torch.from_numpy(SOURCE), cfg, 7, method)
        k, v = E.encode_cross_kv(tp, torch.from_numpy(SOURCE), cfg, 2**32 - 3, method)
    _close(got, want, 2e-5)
    assert k.shape == (2, 2, 64, 2, 32)
    _close(k, jk, 2e-5)
    _close(v, jv, 2e-5)


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_teacher_forced_logits_match_reference(pair, method):
    jm, jp, tm, tp = pair
    want = jax.jit(lambda p, t, s: jm.forward(p, t, jnp.uint32(5), method=method,
                                              extra={"source_embeds": s})[0])(
        jp, jnp.asarray(TOKENS), jnp.asarray(SOURCE))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(TOKENS), 5, method=method,
                            extra={"source_embeds": torch.from_numpy(SOURCE)})
    _close(got, want, 2e-5)
    with torch.no_grad():
        feats, _ = tm.forward(tp, torch.from_numpy(TOKENS), 5, method=method, features_only=True,
                              extra={"source_embeds": torch.from_numpy(SOURCE)})
        assert torch.equal(tm.head(tp, feats, 5, method), got)


def test_cache_spec_matches_reference(pair):
    jm, _, tm, _ = pair
    want, got = jm.cache_spec(3, 40), tm.cache_spec(3, 40)
    assert set(got) == {"self", "cross"}
    assert [(tuple(s), str(d).split(".")[-1]) for s, d in cache_leaves(got)] == \
        [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]


def test_cached_steps_match_reference_and_whole_forward(pair):
    """A ``build_cross`` prefill chunk of 8 (the encoder runs, the cross
    caches are written), then 4 decodes reading them: each step's logits
    within 2e-5 of the reference's, the caches within 1e-5, and the
    logits within 1e-5 of the port's own teacher-forced forward."""
    jm, jp, tm, tp = pair
    extra_j = {"source_embeds": jnp.asarray(SOURCE)}
    extra_t = {"source_embeds": torch.from_numpy(SOURCE)}
    chunk = jax.jit(JSV.make_chunk_prefill_step(jm, method="bf16"))
    dec = jax.jit(JSV.make_decode_step(jm, method="bf16"))
    jc = JSV.init_cache(jm, 2, 32)
    w, jc, jpos = chunk(jp, jnp.asarray(TOKENS[:, :8]), jnp.zeros((2,), jnp.int32), jc, extra_j)
    want = [w]
    for t in range(8, 12):
        w, jc, jpos = dec(jp, jnp.asarray(TOKENS[:, t:t + 1]), jpos, jc)
        want.append(w)
    tchunk = SV.make_chunk_prefill_step(tm, method="bf16")
    tdec = SV.make_decode_step(tm, method="bf16")
    tc = SV.init_cache(tm, 2, 32, "cpu")
    g, tc, tpos = tchunk(tp, torch.from_numpy(TOKENS[:, :8]), torch.zeros((2,), dtype=torch.int32),
                         tc, extra_t)
    got = [g]
    for t in range(8, 12):
        g, tc, tpos = tdec(tp, torch.from_numpy(TOKENS[:, t:t + 1]), tpos, tc)
        got.append(g)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    for g, w in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(g, w, 1e-5)
    with torch.no_grad():
        whole, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method="bf16", extra=extra_t)
    for i, g in enumerate(got):
        _close(g, whole[:, 7 + i], 1e-5)


def test_decode_without_cross_caches_needs_a_source(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="source_embeds"):
        tm.forward(tp, torch.from_numpy(TOKENS), 0, method="bf16")


def test_greedy_generate_equals_teacher_forced_argmax(pair):
    """``greedy_generate`` with a source: every token is the argmax of the
    port's teacher-forced forward over the prompt and the tokens before it
    (f32, bf16 products)."""
    _, _, tm, tp = pair
    tm = build_model(dataclasses.replace(tm.cfg))
    extra = {"source_embeds": torch.from_numpy(SOURCE[:1])}
    prompt = torch.from_numpy(TOKENS[:1, :6])
    out = SV.greedy_generate(tm, tp, prompt, 5, 16, extra=extra, method="bf16")
    seq = torch.cat([prompt, out], 1)
    with torch.no_grad():
        logits, _ = tm.forward(tp, seq[:, :-1], 0, method="bf16", extra=extra)
    assert torch.equal(out[0], torch.argmax(logits[0, 5:], -1).to(torch.int32))
