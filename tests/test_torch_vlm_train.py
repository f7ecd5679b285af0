"""Training the VLM family (reduced llama-3.2-vision-11b: two super-blocks
of a gated cross block and two dense layers): the port against the
reference on the CPU, from one reference init carried over leaf by leaf.

* With the gates set (non-zero, and per block), the mean next-token loss
  over an image and every leaf's gradient (the cross attention with K/V
  from the image through Quartet linears, the tanh-gated residuals, the
  gates' own f32 gradients, the dense layers) against ``jax.grad`` of the
  reference's, f32, under ``bf16``: rtol 1e-4, atol 1e-4·max|ref| per leaf.
* At the initial zero gates the cross blocks add nothing: their weights'
  gradients are exactly 0 in both packages, while the gates' own are not,
  and those equal the reference's within the same tolerance.
* ``make_train_step`` with ``image_embeds`` in the batch against the
  reference's, from the reference's state
  (:func:`_family_train.train_steps_match` states the tolerance).
* Remat (the reference's hierarchical one: each super-block, and each dense
  layer inside it) on against off: the same loss and gradients, bit for
  bit, under Quartet.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _family_train import (grads_close, one_thread, pair, port_loss_grads,  # noqa: F401
                           ref_loss_grads, set_gates, tokens_labels, train_steps_match,
                           with_remat)

from repro_torch.models.vlm import split_counts
from repro_torch.train.steps import _leaf_paths

ARCH = "llama-3.2-vision-11b"
IMAGE = np.random.default_rng(6).standard_normal((4, 64, 128)).astype(np.float32)
GATES = (0.5, -0.3)


@pytest.fixture(scope="module")
def vlm_pair():
    jm, jp, tm, tp = pair(ARCH, key=0)
    assert split_counts(tm.cfg) == (2, 2)
    return jm, jp, tm, tp


def _grads(vlm_pair, gates, seed=6):
    jm, jp, tm, tp = vlm_pair
    jp = {**jp, "cross_layers": dict(jp["cross_layers"])}
    tp = {**tp, "cross_layers": dict(tp["cross_layers"])}
    set_gates(jp, tp, *gates)
    tokens, labels = tokens_labels(2, 12, seed=4)
    jloss, jgrads = ref_loss_grads(jm, jp, jnp.asarray(tokens), jnp.asarray(labels),
                                   {"image_embeds": jnp.asarray(IMAGE[:2])}, seed=seed)
    loss, grads = port_loss_grads(tm, tp, tokens, labels,
                                  {"image_embeds": torch.from_numpy(IMAGE[:2])}, seed=seed)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    return tp, grads, jgrads


def test_model_gradients_with_gates_set_match_reference(vlm_pair):
    tp, grads, jgrads = _grads(vlm_pair, GATES)
    grads_close(tp, grads, jgrads)
    for path, g in zip(_leaf_paths(tp), grads):
        if path[0] == "cross_layers":  # the gates and the cross weights learn
            assert float(g.abs().max()) > 0, path


def test_zero_gates_zero_the_cross_weights_gradients(vlm_pair):
    tp, grads, jgrads = _grads(vlm_pair, (0.0, 0.0))
    for path, g, jg in zip(_leaf_paths(tp), grads, jgrads):
        if path[0] != "cross_layers":
            continue
        if path[-1].startswith("gate"):
            assert float(g.abs().min()) > 0, path
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                       atol=1e-4 * np.abs(np.asarray(jg)).max())
        else:
            assert not g.any() and not np.asarray(jg).any(), path


def test_train_step_with_an_image_matches_reference(vlm_pair):
    jm, jp, tm, tp = vlm_pair
    jp = {**jp, "cross_layers": dict(jp["cross_layers"])}
    tp = {**tp, "cross_layers": dict(tp["cross_layers"])}
    set_gates(jp, tp, *GATES)
    train_steps_match(jm, jp, tm, tp, extra={"image_embeds": IMAGE}, steps=1, seq=12)


def test_remat_on_and_off_give_the_same_gradients(vlm_pair):
    _, _, tm, tp = vlm_pair
    tp = {**tp, "cross_layers": dict(tp["cross_layers"])}
    set_gates({"cross_layers": {}}, tp, *GATES)
    tokens, labels = tokens_labels(2, 12, seed=9)
    extra = {"image_embeds": torch.from_numpy(IMAGE[:2])}
    runs = [port_loss_grads(with_remat(tm, r), tp, tokens, labels, extra, method="quartet",
                            seed=3) for r in (True, False)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
