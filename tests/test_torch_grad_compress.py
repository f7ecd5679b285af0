"""PyTorch port vs the JAX reference: SR-int8 gradient compression.

The same seeded numpy inputs go through ``repro.optim.grad_compress``
(jitted, as the reference's train step runs it) and
``repro_torch.optim.grad_compress`` on the CPU, then through both packages'
``make_train_step(grad_compress=True)`` on the tiny Llama (f32).

Tolerances:
* One round trip: ĝ and the new error bit for bit, from the same g, error
  and key, with leaves whose size is not a multiple of the 256-element
  block (zero padding).
* Train steps, each from the reference's state (params, moments, step,
  error): loss and grad-norm rtol 1e-4, as the dense train test.  The
  gradients reach the round trip differing in their last bits, so an SR
  decision whose uniform lies within that distance of v − floor(v) can
  flip and move ĝ and the error by one int8 step of the block: every flip
  is asserted to sit where |u − (v − floor(v))| ≤ 2e-3 (v ≤ 127 in
  magnitude, the gradients within ~1e-5 of each other), at most 1 in 10^3
  elements.  Elsewhere the error within 1e-4·max|g + err| of its leaf
  (rtol 1e-4 of the gradient's scale: the error is a residual, far smaller
  than the gradient it carries), params rtol 1e-4, atol 1e-4·max|ref|.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import llama_paper as JLP
from repro.data import pipeline as JD
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.optim.grad_compress import compress_decompress_gradient as jcompress
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _leaves, _unflatten
from repro_torch.configs import llama_paper as TLP
from repro_torch.convert import _leaf, params_from_jax
from repro_torch.core import threefry
from repro_torch.data import pipeline as TD
from repro_torch.models import build_model
from repro_torch.optim import adamw, compress_decompress_gradient, cosine_warmup
from repro_torch.optim import grad_compress as GC
from repro_torch.train import steps as TS
from repro_torch.train.loop import train
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves

VOCAB, BATCH, SEQ = 512, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _key(seed: int):
    return (jax.random.fold_in(jax.random.PRNGKey(0xC0), jnp.uint32(seed)),
            threefry.fold_in(threefry.prng_key(0xC0), seed))


@pytest.mark.parametrize("shape", [(1000,), (37, 41), (4, 256), (3, 5, 7)])
def test_round_trip_bit_for_bit(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    g = (rng.standard_normal(shape) * np.exp2(rng.integers(-20, 4))).astype(np.float32)
    err = (rng.standard_normal(shape) * 1e-3 * np.abs(g).max()).astype(np.float32)
    g.reshape(-1)[:3] = [0.0, -0.0, np.abs(g).max()]
    jkey, key = _key(2**31 + 9)
    jg, je = jax.jit(jcompress)(jnp.asarray(g), jnp.asarray(err), jkey)
    tg, te = compress_decompress_gradient(torch.from_numpy(g), torch.from_numpy(err), key)
    _bits(tg.numpy(), jg)
    _bits(te.numpy(), je)
    # a bf16 gradient comes back in bf16 with the same f32 residual
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    jg, je = jax.jit(jcompress)(gb, jnp.asarray(err), jkey)
    tg, te = compress_decompress_gradient(torch.from_numpy(np.array(gb.astype(jnp.float32)))
                                          .to(torch.bfloat16), torch.from_numpy(err), key)
    assert tg.dtype == torch.bfloat16
    _bits(tg.to(torch.float32).numpy(), jg.astype(jnp.float32))
    _bits(te.numpy(), je)


def test_grad_compression_error_feedback():
    """Twin of tests/test_substrate.py's: over many steps the accumulated
    compressed sum tracks the true sum."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for i in range(50):
        ghat, err = compress_decompress_gradient(g_true, err, threefry.prng_key(i))
        acc = acc + ghat
    rel = float(torch.linalg.norm(acc - 50 * g_true) / torch.linalg.norm(50 * g_true))
    assert rel < 0.01


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    import dataclasses

    def tiny(pkg):
        return dataclasses.replace(pkg.tiny_llama(d=128, layers=2, vocab=VOCAB), dtype="float32")

    jm = jbuild(tiny(JLP))
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tiny(TLP)
    return jm, jp, build_model(tcfg), params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _port_state(jstate, like):
    leaves = [_leaf(a, "cpu") if np.ndim(a) else int(a) for a in jax.tree.leaves(jstate)]
    return _unflatten(like, iter(leaves))


def test_train_steps_with_grad_compress_match_reference(tiny_pair, monkeypatch):
    """Three steps of AdamW (cosine warmup, clip 1.0) with ``grad_compress``
    under the bf16 method, each from the reference's state, against the
    reference's ``make_train_step(grad_compress=True)``; the port's round
    trips are recorded to place every SR flip (module docstring)."""
    jm, jp, tm, tp = tiny_pair
    jopt, opt = jadamw(jcosine(1e-3, 10)), adamw(cosine_warmup(1e-3, 10))
    jstep = jax.jit(jmake_train_step(jm, jopt, method="bf16", grad_compress=True))
    jstate = jax.jit(lambda p: jmake_train_state(p, jopt, grad_compress=True))(jp)
    step = make_train_step(tm, opt, method="bf16", grad_compress=True)
    state = make_train_state(tp, opt, grad_compress=True)
    assert all(e.dtype == torch.float32 and not e.any() for e in tree_leaves(state.err))
    calls = []

    def recorded(g, err, key):
        out = compress_decompress_gradient(g, err, key)
        calls.append((g + err, key))
        return out

    monkeypatch.setattr(TS, "compress_decompress_gradient", recorded)
    batcher = JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), BATCH, SEQ)
    flips = total = 0
    for i in range(3):
        b = batcher.batch(i)
        state = _port_state(jstate, state)
        calls.clear()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-4)
        errs, jerrs = tree_leaves(state.err), jax.tree.leaves(jstate.err)
        assert len(calls) == len(errs) == len(jerrs) == 12
        for (gf, key), e, je, p, jp_ in zip(calls, errs, jerrs, tree_leaves(state.params),
                                           jax.tree.leaves(jstate.params)):
            q, scale = GC._sr_int8(gf, key)
            v = torch.nn.functional.pad(gf.reshape(-1), (0, q.numel() - gf.numel())) \
                .reshape(q.shape) / scale
            u = threefry.uniform(key, q.shape, "cpu")
            je = torch.from_numpy(np.asarray(je))
            # the reference's codes, from its residual: ĝ = g + err − err'
            jq = torch.round((torch.nn.functional.pad((gf - je).reshape(-1),
                                                      (0, q.numel() - gf.numel()))
                              .reshape(q.shape)) / scale)
            flip = (jq != q.to(torch.float32)).reshape(-1)[: gf.numel()].reshape(gf.shape)
            near = (u - (v - torch.floor(v))).abs().reshape(-1)[: gf.numel()].reshape(gf.shape)
            assert bool((near[flip] <= 2e-3).all()), near[flip]
            flips += int(flip.sum())
            total += flip.numel()
            tol = 1e-4 * float(gf.abs().max())
            assert bool(((e - je).abs()[~flip] <= tol).all()), float((e - je).abs().max())
            jp_ = np.asarray(jp_)
            ok = np.abs(p.numpy() - jp_) <= 1e-4 * np.abs(jp_).max() + 1e-4 * np.abs(jp_)
            assert bool(ok[~flip.numpy()].all())
    assert flips <= 1e-3 * total, (flips, total)


def test_train_resume_restores_err_and_reference_checkpoint_loads(tiny_pair, tmp_path):
    """``train(grad_compress=True)``: stopped after 1 step and started again
    from its checkpoint, the run ends with the unbroken run's params and
    error bit for bit; a reference checkpoint holding ``err`` restores into
    the port's state leaf by leaf."""
    jm, jp, tm, tp = tiny_pair
    batcher = TD.TokenBatcher(TD.SyntheticC4Dataset(VOCAB, seed=0), 2, SEQ)
    opt = adamw(cosine_warmup(1e-3, 3))
    quiet = {"device": "cpu", "log_fn": lambda *_: None, "grad_compress": True,
             "method": "bf16", "params": tp}
    whole, _ = train(tm, opt, batcher, 2, **quiet)
    ck = str(tmp_path / "ck")
    train(tm, opt, batcher, 1, checkpoint_dir=ck, **quiet)
    again, rest = train(tm, opt, batcher, 2, checkpoint_dir=ck, **quiet)
    assert len(rest) == 1 and any(bool(e.any()) for e in tree_leaves(again.err))
    for a, b in zip(_leaves(again), _leaves(whole)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    jopt = jadamw(jcosine(1e-3, 3))
    jstate = jax.jit(lambda p: jmake_train_state(p, jopt, grad_compress=True))(jp)
    b = JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), 2, SEQ).batch(0)
    jstate, _ = jax.jit(jmake_train_step(jm, jopt, method="bf16", grad_compress=True))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    JCheckpointer(str(tmp_path / "ref")).save(1, jstate, blocking=True)
    restored, meta = Checkpointer(str(tmp_path / "ref")).restore(
        make_train_state(tp, opt, grad_compress=True))
    assert meta["step"] == 1 and restored.step == 1
    for a, ja in zip(tree_leaves(restored.err), jax.tree.leaves(jstate.err)):
        assert a.dtype == torch.float32 and bool(a.any())
        _bits(a.numpy(), ja)


def test_launcher_baseline_with_grad_compress(monkeypatch, capsys):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--device", "cpu", "--steps", "2",
                                      "--batch", "2", "--seq", "32", "--method", "luq_int4",
                                      "--grad-compress"])
    launcher.main()
    out = capsys.readouterr().out
    assert "final loss" in out and "steps 0..1" in out
