"""Training the enc-dec family (reduced whisper-tiny: LayerNorm, absolute
positions, GELU with biases, a tied head): the port against the reference
on the CPU, from one reference init carried over leaf by leaf.

* The mean next-token loss of the decoder over a source and every leaf's
  gradient (the encoder, the decoder's self and cross attention with K/V
  from the encoder's memory through Quartet linears, the LayerNorms'
  fixed-order sums, the tied embedding; the absolute position table is a
  constant) against ``jax.grad`` of the reference's, f32, under ``bf16``:
  rtol 1e-4, atol 1e-4·max|ref| per leaf.
* ``make_train_step`` with ``source_embeds`` in the batch and microbatch 2
  (each microbatch takes its rows of the source) against the reference's,
  from the reference's state (:func:`_family_train.train_steps_match`
  states the tolerance); ``make_eval_step`` with the source against the
  reference's: nll within rtol 1e-5.
* ``train.loop.train(..., extra_batch=)``: two steps on the CPU equal two
  ``make_train_step`` calls on the batches with the source joined, bit for
  bit; without a source the encoder's error is raised.
* Remat (each encoder and decoder layer) on against off: the same loss and
  gradients, bit for bit, under Quartet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _family_train import (VOCAB, grads_close, one_thread, pair,  # noqa: F401
                           port_loss_grads, ref_loss_grads, tokens_labels, train_steps_match,
                           with_remat)

from repro.data import pipeline as JD
from repro.train.steps import make_eval_step as jmake_eval_step
from repro_torch.data import pipeline as TD
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import _leaf_paths, make_eval_step, make_train_step

ARCH = "whisper-tiny"
SOURCE = np.random.default_rng(5).standard_normal((4, 48, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def encdec_pair():
    return pair(ARCH, key=3)


def test_model_gradients_match_reference(encdec_pair):
    jm, jp, tm, tp = encdec_pair
    tokens, labels = tokens_labels(2, 12, seed=4)
    src = SOURCE[:2]
    jloss, jgrads = ref_loss_grads(jm, jp, jnp.asarray(tokens), jnp.asarray(labels),
                                   {"source_embeds": jnp.asarray(src)}, seed=6)
    loss, grads = port_loss_grads(tm, tp, tokens, labels,
                                  {"source_embeds": torch.from_numpy(src)}, seed=6)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    grads_close(tp, grads, jgrads)
    by_path = dict(zip(_leaf_paths(tp), grads))
    for path in (("encoder", "layers", "attn", "wq", "w"), ("encoder", "final_norm", "bias"),
                 ("decoder", "layers", "cross_attn", "wk", "w"),
                 ("decoder", "layers", "cross_norm", "scale"), ("embed", "table")):
        assert float(by_path[path].abs().max()) > 0, path


def test_train_and_eval_steps_with_a_source_match_reference(encdec_pair):
    jm, jp, tm, tp = encdec_pair
    state, _ = train_steps_match(jm, jp, tm, tp, extra={"source_embeds": SOURCE}, steps=1,
                                 microbatch=2, batch=4, seq=12)
    b = {**JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), 4, 12).batch(5),
         "source_embeds": SOURCE}
    want = jax.jit(jmake_eval_step(jm, method="bf16"))(jp, {k: jnp.asarray(v)
                                                            for k, v in b.items()})
    got = make_eval_step(tm, method="bf16")(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(got["nll"]) - float(want["nll"])) <= 1e-5 * abs(float(want["nll"]))


def test_train_loop_takes_the_source_as_extra_batch(encdec_pair):
    _, _, tm, tp = encdec_pair
    batcher = TD.TokenBatcher(TD.SyntheticC4Dataset(VOCAB, seed=0), 4, 12)
    extra = {"source_embeds": SOURCE}
    opt = adamw(cosine_warmup(1e-3, 10))
    _, hist = train(tm, opt, batcher, 2, params=tp, extra_batch=extra, device="cpu",
                    method="bf16", microbatch=2, log_fn=lambda *_: None)
    step = make_train_step(tm, opt, method="bf16", microbatch=2)
    state = make_train_state(tp, opt)
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in {**batcher.batch(i), **extra}.items()}
        state, met = step(state, b)
        assert hist[i]["loss"] == float(met["loss"]) and np.isfinite(hist[i]["loss"])
        assert hist[i]["grad_norm"] == float(met["grad_norm"])
    with pytest.raises(ValueError, match="source_embeds"):
        train(tm, opt, batcher, 1, params=tp, device="cpu", method="bf16",
              log_fn=lambda *_: None)


def test_remat_on_and_off_give_the_same_gradients(encdec_pair):
    _, _, tm, tp = encdec_pair
    tokens, labels = tokens_labels(2, 12, seed=9)
    extra = {"source_embeds": torch.from_numpy(SOURCE[:2])}
    runs = [port_loss_grads(with_remat(tm, r), tp, tokens, labels, extra, method="quartet",
                            seed=3) for r in (True, False)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
