"""PyTorch port vs the JAX reference: Quartet training.

The same seeded numpy inputs go through the reference and the port on the
CPU: the Algorithm-1 backward of ``quartet_linear`` on both paths, the
tiny Llama's chunked loss and its gradients from one reference init (carried
over by ``params_from_jax``), and three AdamW train steps with microbatch
accumulation on the same ``TokenBatcher`` batches.

Tolerances.  ``quartet_linear``'s dx and dW: rtol 1e-5, atol 1e-6·max|ref|
(bit-exact stochastic-rounding operands, f32 sums in another order).  The
plain path's rotations sum in the reference's CPU order here
(``use_reference_dot_order``), so its stochastic-rounding operands carry the
reference's bits; the port's own matrix product can differ by an ulp, and an
ulp can flip a rounding decision.  Model
loss and gradients, train-step loss, grad-norm and params: rtol 1e-4, atol
1e-4·max|ref| per leaf (the atol covers elements near zero, where an f32
rounding difference in a gradient flips the sign of an Adam update).  The
model runs in f32 (ROADMAP C1: bf16 rounding flips QuEST decisions).  The
rest of the network's backward (norms, attention, SwiGLU) rounds differently
in the two libraries, so a stochastic-rounding decision downstream can flip
and move one gradient column by a grid step; on these seeds none does.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import use_reference_dot_order

import repro.core.quartet as JQ
from repro.configs import get_config as jget_config
from repro.configs import llama_paper as JLP
from repro.data import pipeline as JD
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_warmup as jcosine
from repro.train.losses import chunked_lm_loss as jchunked_lm_loss
from repro.train.losses import cross_entropy_loss as jcross_entropy
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs import llama_paper as TLP
from repro_torch.convert import params_from_jax
from repro_torch.core.quartet import BF16_CONFIG, QuartetConfig, quartet_linear
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, clip_by_global_norm, cosine_warmup
from repro_torch.train.loop import evaluate, train
from repro_torch.train.losses import chunked_lm_loss, cross_entropy_loss
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

VOCAB, BATCH, SEQ, MICRO = 512, 4, 16, 2


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


def _tiny(pkg_cfg):
    return dataclasses.replace(pkg_cfg.tiny_llama(d=128, layers=2, vocab=VOCAB),
                               dtype="float32")


# ---------------------------------------------------------------------------
# quartet_linear: the Algorithm-1 backward
# ---------------------------------------------------------------------------

CASES = {
    "x64x256_w256x128": ((64, 256), 128),
    "n_not_multiple_of_32": ((64, 64), 72),  # the zero-padding path
    "leading_dims": ((2, 8, 4, 64), 32),
}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_quartet_linear_backward_vs_reference(case, use_kernels, monkeypatch):
    """Port ``use_kernels=False`` against the reference's jnp path, and
    ``use_kernels=True`` (the kernels' plain versions) against the reference's
    Pallas path in interpret mode: same inputs, same seed.  (The kernel
    path's butterfly Hadamard rounds differently from the reference's
    matrix product, so on rare inputs a QuEST or SR decision differs; these
    inputs have none.)"""
    use_reference_dot_order(monkeypatch)
    xshape, n = CASES[case]
    rng = np.random.default_rng(12)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal((xshape[-1], n)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((*xshape[:-1], n)).astype(np.float32)
    jcfg = JQ.QuartetConfig(use_kernels=use_kernels)
    jy, jdx, jdw = jax.jit(lambda a, b, d: (lambda y, f: (y, *f(d)))(
        *jax.vjp(lambda a, b: JQ.quartet_linear(a, b, jnp.uint32(5), jcfg), a, b)))(x, w, dy)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = quartet_linear(xt, wt, 5, QuartetConfig(use_kernels=use_kernels))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    _close(dx.numpy(), jdx, 1e-5, 1e-6)
    _close(dw.numpy(), jdw, 1e-5, 1e-6)


def test_quartet_linear_bf16_passthrough_backward_vs_reference():
    """``fwd_quantizer="none"`` (the bf16 lm-head's config): f32 dx and dW."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    dy = rng.standard_normal((3, 16, 40)).astype(np.float32)
    _, f = jax.vjp(lambda a, b: JQ.quartet_linear(a, b, jnp.uint32(1), JQ.BF16_CONFIG), x, w)
    jdx, jdw = f(dy)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(quartet_linear(xt, wt, 1, BF16_CONFIG), (xt, wt),
                                 torch.from_numpy(dy))
    _close(dx.numpy(), jdx, 1e-5, 1e-6)
    _close(dw.numpy(), jdw, 1e-5, 1e-6)


# ---------------------------------------------------------------------------
# the model: chunked loss and its gradients from one init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """The reference's tiny Llama (f32) and its init, the same weights in the
    port, and the first microbatch of train step 0 (its seed is 2)."""
    jm = jbuild(_tiny(JLP))
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = _tiny(TLP)
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    batch = TD.TokenBatcher(TD.SyntheticC4Dataset(VOCAB, seed=0), BATCH, SEQ).batch(0)
    return jm, jp, build_model(tcfg), tp, {k: v[:BATCH // MICRO] for k, v in batch.items()}


@pytest.mark.parametrize("method", ["quartet", "bf16"])
def test_lm_loss_and_grads_match_reference(tiny_pair, method, monkeypatch):
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp, batch = tiny_pair
    seed = 2

    def jloss(p):
        feats, _, _ = jm.forward(p, jnp.asarray(batch["tokens"]), jnp.uint32(seed),
                                 method=method, features_only=True)
        return jchunked_lm_loss(jm.head, p, feats, jnp.asarray(batch["labels"]),
                                jnp.uint32(seed), method=method)[0]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    feats, _ = tm.forward(params, torch.from_numpy(batch["tokens"]), seed, method=method,
                          features_only=True)
    loss, _ = chunked_lm_loss(tm.head, params, feats, torch.from_numpy(batch["labels"]),
                              seed, method=method)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.detach().numpy(), jv, 1e-4, 0.0)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads) == 12
    for g, jgl in zip(grads, jleaves):
        _close(g.numpy(), jgl, 1e-4, 1e-4)


def test_remat_gives_identical_grads(tiny_pair):
    """``torch.utils.checkpoint`` recomputes each layer with the same seeds:
    the same bits as keeping the activations, on both Quartet paths."""
    _, _, tm, tp, batch = tiny_pair
    for use_kernels in (False, True):
        got = []
        for remat in (True, False):
            cfg = dataclasses.replace(tm.cfg, remat=remat, quartet=QuartetConfig(
                use_kernels=use_kernels))
            m = build_model(cfg)
            leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
            params = tree_unflatten(tp, leaves)
            feats, _ = m.forward(params, torch.from_numpy(batch["tokens"]), 9,
                                 features_only=True)
            loss, _ = chunked_lm_loss(m.head, params, feats,
                                      torch.from_numpy(batch["labels"]), 9)
            got.append(torch.autograd.grad(loss, leaves))
        for a, b in zip(*got):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------


def test_train_steps_match_reference(tiny_pair, monkeypatch):
    """3 steps of AdamW (cosine warmup, clip 1.0, microbatch 2) from the
    same init on the same batches: per-step loss and grad-norm, then every
    parameter after step 3."""
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp, _ = tiny_pair
    batcher = JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), BATCH, SEQ)
    jopt = jadamw(jcosine(1e-3, 10))
    jstep = jax.jit(jmake_train_step(jm, jopt, microbatch=MICRO))
    jstate = jmake_train_state(jp, jopt)
    opt = adamw(cosine_warmup(1e-3, 10))
    step = make_train_step(tm, opt, microbatch=MICRO)
    state = make_train_state(tp, opt)
    for i in range(3):
        b = batcher.batch(i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "nll"):
            _close(float(m[key]), float(jm_[key]), 1e-4, 0.0)
    assert state.step == 3 and int(jstate.step) == 3
    for p, jp_ in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        _close(p.numpy(), jp_, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# the pieces of the stack
# ---------------------------------------------------------------------------


def test_cross_entropy_and_chunking_match_reference():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((2, 12, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.7).astype(np.float32)
    jl, jmet = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), 1e-3)
    tl, tmet = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(mask), 1e-3)
    _close(tl.numpy(), jl, 1e-6, 0.0)
    _close(tmet["z_loss"].numpy(), jmet["z_loss"], 1e-6, 0.0)
    # chunked: a linear head over 3 chunks of 4 equals the whole-sequence loss
    feats = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((8, 50)).astype(np.float32)

    def head(p, x, seed, method):
        return x @ p

    whole, _ = cross_entropy_loss(torch.from_numpy(feats @ w), torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    chunked, _ = chunked_lm_loss(head, torch.from_numpy(w), torch.from_numpy(feats),
                                 torch.from_numpy(labels), 0, torch.from_numpy(mask), chunk=4)
    _close(chunked.numpy(), whole.numpy(), 1e-6, 0.0)


def test_optimizer_schedule_and_clip_match_reference():
    rng = np.random.default_rng(14)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((16,)).astype(np.float32)}}
    grads = {"a": rng.standard_normal((4, 8)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((16,)).astype(np.float32) * 3}}
    jlr, tlr = jcosine(3e-4, 20), cosine_warmup(3e-4, 20)
    for s in (0, 1, 2, 5, 13, 20, 25):
        _close(tlr(s), float(jlr(s)), 1e-6, 0.0)
    t = lambda tr: {k: t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                    for k, v in tr.items()}
    jg, jn = jclip(grads, 1.0)
    tg, tn = clip_by_global_norm(t(grads), 1.0)
    _close(tn.numpy(), jn, 1e-6, 0.0)
    jopt, topt = jadamw(jlr), adamw(tlr)
    js, ts = jopt.init(tree), topt.init(t(tree))
    for _ in range(3):
        ju, js = jopt.update(jg, js, tree)
        tu, ts = topt.update(tg, ts, t(tree))
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            _close(a.numpy(), b, 1e-5, 1e-6)
    assert ts["step"] == 3


def test_data_pipeline_matches_reference(tmp_path):
    for seed in (0, 3):
        jb = JD.TokenBatcher(JD.SyntheticC4Dataset(32000, seed=seed), 3, 40, seed=seed)
        tb = TD.TokenBatcher(TD.SyntheticC4Dataset(32000, seed=seed), 3, 40, seed=seed)
        for step in (0, 1, 7):
            for k, v in jb.batch(step).items():
                np.testing.assert_array_equal(tb.batch(step)[k], v)
    path = tmp_path / "tokens.bin"
    np.random.default_rng(15).integers(0, 1000, 5000).astype(np.uint16).tofile(path)
    jds, tds = JD.make_dataset(str(path), 1000), TD.make_dataset(str(path), 1000)
    np.testing.assert_array_equal(tds.slice(4990, 30), jds.slice(4990, 30))


def test_llama_paper_configs_match_reference():
    for name, cfg in TLP.PAPER_FAMILY.items():
        jcfg = jget_config(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "tie_embeddings", "remat", "dtype"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.n_params() == jcfg.n_params()
        assert get_config(name) == cfg
    assert TLP.LEARNING_RATES == JLP.LEARNING_RATES
    c = get_config("llama-paper-200m")
    assert (c.num_layers, c.d_model, c.num_heads, c.head_dim_, c.d_ff, c.vocab_size) == (
        10, 1280, 10, 128, 3456, 32000)
    assert 197e6 < c.n_params() < 199e6 and 279e6 < c.n_params(non_embedding=False) < 281e6
    assert get_reduced_config("llama-paper-200m") == TLP.tiny_llama(128, 2, 512)
    with pytest.raises(ValueError):
        get_config("llama-paper-1t")


def test_params_from_jax_carries_llama_tree(tiny_pair):
    jm, jp, tm, tp, _ = tiny_pair
    assert set(tp) == {"embed", "layers", "final_norm", "lm_head"}
    assert tp["lm_head"]["w"].shape == (128, VOCAB)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bad = jax.device_get(jp)
    bad = {k: v for k, v in bad.items() if k != "lm_head"}
    with pytest.raises(ValueError):
        params_from_jax(bad, tm.cfg, "cpu")


def test_train_loop_and_launcher_on_cpu(tiny_pair, monkeypatch, capsys):
    """``train`` runs the port's steps and reports finite metrics;
    ``evaluate`` scores held-out batches; the launcher runs the reduced
    config on the CPU and refuses ``cuda`` without a GPU; checkpointing is
    not ported yet."""
    _, _, tm, tp, _ = tiny_pair
    batcher = TD.TokenBatcher(TD.SyntheticC4Dataset(VOCAB, seed=0), 2, SEQ)
    opt = adamw(cosine_warmup(1e-3, 3))
    state, hist = train(tm, opt, batcher, 3, params=tp, device="cpu", log_fn=lambda *_: None)
    assert state.step == 3 and [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert np.isfinite(evaluate(tm, state, batcher, 2, device="cpu"))
    with pytest.raises(NotImplementedError, match="checkpointer"):
        train(tm, opt, batcher, 1, params=tp, device="cpu", checkpoint_dir="ckpt")
    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--device", "cpu", "--steps", "2",
                                      "--batch", "2", "--seq", "16"])
    train_launcher.main()
    assert "final loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--steps", "1"])
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_launcher.main()
