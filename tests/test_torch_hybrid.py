"""The hybrid family (zamba2-7b reduced: 5 Mamba2 layers in 2 groups of 2
and a 1-layer tail, the shared attention block before each group): the port
against the reference on the CPU.

One reference init crosses over leaf by leaf (``params_from_jax``:
``mamba_layers`` stacked, ``shared_attn`` one block, an untied head); both
packages run the whole model, under QuEST, under the plain bf16 products
and under SR-AbsMax (whose draws take each linear's seed, so equal logits
show the port's per-application and per-layer seeds are the reference's),
and the serving steps over the cache tree.  Tolerances are the Mamba2
block's (``tests/test_torch_mamba2.py``: ``cumsum`` and the einsums sum in
other orders): logits within 2e-5 of max |ref| (measured ≤ 5.3e-6 of it),
the caches within 1e-5.  The variant at head dim 112 is held in
``tests/test_torch_hybrid_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.core.quartet import QuartetConfig as JQuartetConfig
from repro.models import build_model as jbuild
from repro.train import serve as JSV
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.core.quartet import QuartetConfig
from repro_torch.models import build_model
from repro_torch.models.registry import cache_leaves
from repro_torch.train import serve as SV

ARCH = "zamba2-7b"
TOKENS = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(dtype="float32", fwd_quantizer=None, **over):
    """(reference model, port model) of the reduced config with ``over``."""
    jover, tover = dict(over), dict(over)
    if fwd_quantizer is not None:
        jover["quartet"] = JQuartetConfig(fwd_quantizer=fwd_quantizer)
        tover["quartet"] = QuartetConfig(fwd_quantizer=fwd_quantizer)
    jcfg = dataclasses.replace(jget_reduced(ARCH, dtype=dtype), **jover)
    tcfg = dataclasses.replace(get_reduced_config(ARCH, dtype=dtype), **tover)
    return jbuild(jcfg), build_model(tcfg)


def _pair(**over):
    jm, tm = _models(**over)
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, tm, params_from_jax(jax.device_get(jp), tm.cfg, "cpu")


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


@pytest.fixture(scope="module")
def ref_steps(f32_pair):
    """The reference's chunk + decodes (f32, method bf16): logits, caches."""
    return _steps_ref(f32_pair[0], f32_pair[1], "bf16")


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


def test_config_and_n_params():
    """The published widths; ``n_params`` is the reference's formula (the
    shared block counted once an application); the stored tree is smaller."""
    from repro.configs import get_config as jget

    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "ssm_state", "ssm_variant", "ssm_expand", "ssm_head_dim",
              "ssm_chunk", "ssm_conv", "attn_every", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_params() == jcfg.n_params() == 8_986_491_472
    assert cfg.n_params(non_embedding=False) == jcfg.n_params(non_embedding=False)
    assert get_reduced_config(ARCH).n_params() == jget_reduced(ARCH).n_params()


def test_init_tree_matches_reference(f32_pair):
    """The port's own init: the reference's paths, shapes and dtypes."""
    _, jp, tm, _ = f32_pair
    tp = init_params(tm.cfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: (np.shape(v), str(np.asarray(v).dtype)) for k, v in _flat(jax.device_get(jp)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(tp).items()}
    assert got == want
    # log of linspace(1, 16): each within 1 ulp (the two libraries' f32 log)
    np.testing.assert_allclose(tp["mamba_layers"]["A_log"].numpy(),
                               np.asarray(jp["mamba_layers"]["A_log"]), rtol=2.0**-23)


def test_params_from_jax_checks_shapes(f32_pair):
    _, jp, tm, _ = f32_pair
    tree = jax.device_get(jp)
    bad = {**tree, "mamba_layers": {**tree["mamba_layers"],
                                    "D": np.asarray(tree["mamba_layers"]["D"])[:, :3]}}
    with pytest.raises(ValueError, match="mamba_layers.D"):
        params_from_jax(bad, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="param tree"):
        params_from_jax({k: v for k, v in tree.items() if k != "shared_attn"}, tm.cfg, "cpu")


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_model_logits_match_reference(f32_pair, method):
    jm, jp, tm, tp = f32_pair
    want = jax.jit(lambda p, t: jm.forward(p, t, jnp.uint32(0), method=method)[0])(
        jp, jnp.asarray(TOKENS))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    _close(got, want, 2e-5)


def test_logits_under_sr_absmax_match_reference(f32_pair):
    """SR-AbsMax draws from each linear's seed: the shared block's 2
    applications, every group's layers and the tail each take the
    reference's seed, or the draws (and logits) would differ.  Seed
    2^32 − 5 wraps."""
    _, jp, _, tp = f32_pair  # the same weights under another quantizer
    jm, tm = _models(fwd_quantizer="sr_absmax")
    seed = 2**32 - 5
    want = jax.jit(lambda p, t: jm.forward(p, t, jnp.uint32(seed), method="quartet")[0])(
        jp, jnp.asarray(TOKENS))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(TOKENS), seed, method="quartet")
    _close(got, want, 2e-5)
    with torch.no_grad():
        other, _ = tm.forward(tp, torch.from_numpy(TOKENS), seed + 1 - 2**32, method="quartet")
    assert not torch.equal(other, got)  # the draws do depend on the seed


def test_cache_spec_matches_reference(f32_pair):
    jm, _, tm, _ = f32_pair
    for B, T in ((1, 16), (3, 40)):
        want = jm.cache_spec(B, T)
        got = tm.cache_spec(B, T)
        assert set(got) == {"attn", "mamba"}
        for key in ("attn", "mamba"):
            assert [(tuple(s), str(d).split(".")[-1]) for s, d in cache_leaves(got[key])] == \
                [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want[key])]


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


def test_cache_steps_match_reference(f32_pair, ref_steps):
    """A prefill chunk of 8 then 4 decodes over the cache tree: every step's
    logits within 2e-5 of max |ref|, the final KV and state caches within
    1e-5."""
    _, _, tm, tp = f32_pair
    want, jcache = ref_steps
    got, cache = _steps_port(tm, tp, "bf16")
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    assert cache["attn"][0].shape == (2, 2, 32, 4, 32)
    assert cache["mamba"][1].dtype == torch.float32
    for g, w in zip(cache_leaves(cache), jax.tree.leaves(jcache)):
        _close(g, w, 1e-5)


def test_cache_steps_in_bf16_within_the_references_bf16_spread(f32_pair, ref_steps):
    """The same steps in bf16 (every floating leaf cast first, on both
    sides; bf16 KV and conv caches).  The shared block's attention rounds
    its f32 softmax otherwise than XLA (≤ 1e-7, ROADMAP C), which flips a
    bf16 rounding now and then; 5 layers carry that to the logits.  So each
    step's port logits must lie no farther from the reference's bf16 logits
    than those lie from the reference's own f32 logits."""
    _, jp, _, tp = f32_pair  # the steps cast every floating leaf to bf16
    jm, tm = _models("bfloat16")
    want, _ = _steps_ref(jm, jp, "bf16")
    want32, _ = ref_steps
    got, cache = _steps_port(tm, tp, "bf16")
    assert cache["attn"][0].dtype == cache["mamba"][0].dtype == torch.bfloat16
    for g, w, w32 in zip(got, want, want32):
        g, w, w32 = _np(g), _np(w), _np(w32)
        assert np.abs(g - w).max() <= np.abs(w32 - w).max()


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_chunked_prefill_matches_whole_forward(f32_pair, method):
    """The port's chunk + decodes against its own teacher-forced forward:
    a chunk of 8 runs one SSD chunk of 8, the whole forward of 12 chunks of
    4 (12 halved from 32), so the logits agree within 1e-5, not bit for
    bit."""
    _, _, tm, tp = f32_pair
    got, _ = _steps_port(tm, tp, method)
    with torch.no_grad():
        whole, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    for i, g in enumerate(got):
        _close(g, whole[:, 7 + i], 1e-5)


def test_build_model_gates():
    cfg = get_reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="mamba1"):
        build_model(dataclasses.replace(cfg, ssm_variant="mamba1"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="retnet"))
