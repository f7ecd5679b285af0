"""PyTorch port vs the JAX reference: the dense model forward.

The reference initialises reduced qwen3-1.7b (2 layers, d=128, hd=32); its
params cross over leaf by leaf (``repro_torch.convert.params_from_jax``) and
both packages score the same tokens, teacher-forced, in f32.

A reduced Llama built with ``attn_backend="flash"`` on both sides runs the
flash kernel (the reference's in interpret mode, the port's plain version)
in its cache-free forward and in ``evaluate``.

Tolerance: 2e-5 on the logits under both methods.  Under ``bf16`` the two
sides differ only in summation order.  Under ``quartet`` a one-ulp change in
a linear layer's input can also flip a QuEST rounding decision and move the
logits by O(0.1) (ROADMAP C1); on this seed no decision flips, because the
port's plain path rounds exactly as the reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses
import types

from repro.configs import get_reduced_config as jget_reduced
from repro.configs import llama_paper as JLP
from repro.data import pipeline as JD
from repro.models import build_model as jbuild
from repro.train.loop import evaluate as jevaluate
from repro_torch.configs import llama_paper as TLP
from repro_torch.data import pipeline as TD
from repro_torch.train.loop import evaluate
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model


TOKENS = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)


@pytest.fixture(scope="module")
def f32_pair():
    """Reference logits under both methods, and the same weights in the port."""
    jm = jbuild(jget_reduced("qwen3-1.7b", dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    want = {m: np.asarray(jax.jit(lambda p, t, m=m: jm.forward(
        p, t, jnp.uint32(0), method=m)[0])(jp, jnp.asarray(TOKENS))) for m in ("bf16", "quartet")}
    tcfg = get_reduced_config("qwen3-1.7b", dtype="float32")
    return want, tcfg, params_from_jax(jax.device_get(jp), tcfg, "cpu")


@pytest.mark.parametrize("method", ["bf16", "quartet"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_forward_logits_match_reference(f32_pair, method, use_kernels):
    want, tcfg, tp = f32_pair
    if use_kernels:
        tcfg = kernel_config(tcfg)
    got, _ = build_model(tcfg).forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    assert got.dtype == torch.float32 and got.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want[method], rtol=0, atol=2e-5)


def test_params_from_jax_keeps_bf16_bits_and_layout():
    jcfg = jget_reduced("qwen3-1.7b")
    tcfg = get_reduced_config("qwen3-1.7b")
    jp = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, tcfg, "cpu")
    wq = tp["layers"]["attn"]["wq"]["w"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 128, 128)
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"]["w"]).view(np.int16))
    with pytest.raises(ValueError, match="needs"):
        params_from_jax(jp, get_reduced_config("qwen3-1.7b", num_layers=3), "cpu")


def test_init_params_tree_shapes_and_laws():
    """The port's own init draws the reference's tree, shapes and init laws
    (not its draws: torch and jax generators differ)."""
    cfg = get_reduced_config("qwen3-1.7b")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.device_get(jbuild(jget_reduced("qwen3-1.7b")).init(jax.random.PRNGKey(0)))
    def sig(a):
        return tuple(a.shape), str(a.dtype).removeprefix("torch.")

    assert jax.tree.map(sig, p) == jax.tree.map(sig, jp)
    for path, std in ((("embed", "table"), cfg.d_model**-0.5),
                      (("layers", "mlp", "down", "w"), cfg.d_ff**-0.5)):
        t, j = p, jp
        for k in path:
            t, j = t[k], j[k]
        t, j = t.float().numpy(), np.asarray(j, np.float32)
        assert abs(t.std() / j.std() - 1) < 0.05
        assert np.abs(t).max() <= 3 * std * 1.01  # truncated at 3σ (bf16 rounding)
    from repro.configs import get_config as jget
    assert (get_config("qwen3-1.7b").n_params(non_embedding=False)
            == jget("qwen3-1.7b").n_params(non_embedding=False))


@pytest.fixture(scope="module")
def flash_llama():
    """The tiny Llama (2 layers, d 128, 2 heads of 64, f32) built with the
    flash backend on both sides, from one reference init."""
    jcfg = dataclasses.replace(JLP.tiny_llama(d=128, layers=2, vocab=512), dtype="float32")
    tcfg = dataclasses.replace(TLP.tiny_llama(d=128, layers=2, vocab=512), dtype="float32")
    jm = jbuild(jcfg, attn_backend="flash")
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp, build_model(tcfg, attn_backend="flash"), params_from_jax(
        jax.device_get(jp), tcfg, "cpu")


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_flash_built_forward_matches_reference(flash_llama, method):
    jm, jp, tm, tp = flash_llama
    assert tm.cfg.attn_backend == "flash"
    tokens = np.random.default_rng(4).integers(0, 512, (2, 40)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, jnp.uint32(0), method=method)[0])(
        jp, jnp.asarray(tokens)))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(tokens), 0, method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_flash_evaluate_matches_reference(flash_llama):
    jm, jp, tm, tp = flash_llama
    jb = JD.TokenBatcher(JD.SyntheticC4Dataset(512, seed=1), 2, 32)
    tb = TD.TokenBatcher(TD.SyntheticC4Dataset(512, seed=1), 2, 32)
    want = jevaluate(jm, types.SimpleNamespace(params=jp), jb, 2)
    got = evaluate(tm, types.SimpleNamespace(params=tp), tb, 2, device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)
