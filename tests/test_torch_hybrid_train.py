"""Training the hybrid family (Mamba2 and a shared attention block, reduced
zamba2-7b): the port's gradients against the reference's on the CPU, from
one reference init carried over leaf by leaf.

* One ``mamba2_block`` forward and backward under Quartet (the SSD chunk
  scan's backward, its mask inside the exp; ``dt_bias``, ``gate_norm``;
  ``in_proj``'s ragged width of 2·256 + 2·16 + 8 = 552 padded to 576 in the
  backward) against ``jax.vjp`` of the reference's plain path, with the
  reference's CPU dot order patched in and 256-row operands (ROADMAP C4):
  output and gradients within rtol 1e-4 (atol 1e-5·max|ref| for the output,
  1e-4 for the gradients), but a weight's gradient may have one column
  outside, within 1% of max|ref|: the scan's backward sums in other orders
  than XLA's, and one stochastic-rounding decision of ``in_proj``'s dW
  stage flips here (118 elements of one column, by 0.4% of max|ref|).
  The softplus of dt takes ``logaddexp``'s derivative, ½ at 0, where
  autograd through max and |x| gave 1: ``in_proj``'s output is exactly 0
  in some rows under Quartet, and dt's gradient there was twice the
  reference's (ROADMAP C12).
* The reduced hybrid (5 layers, ``attn_every`` 2: two super-blocks and a
  tail, so the shared block is applied twice, with seeds ``seed`` and
  ``seed + 7919``, and its gradient is the sum over both): the mean
  next-token loss and every leaf's gradient, the shared block's included,
  against ``jax.grad`` of the reference's, f32, under ``bf16``: rtol 1e-4,
  atol 1e-4·max|ref| per leaf.
* Remat (the reference's hierarchical one: each super-block, and each
  Mamba2 layer inside it) on against off: the same loss and gradients, bit
  for bit, under Quartet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _family_train import (grads_close, one_thread, pair, port_loss_grads,  # noqa: F401
                           ref_block_vjp, ref_loss_grads, tokens_labels, with_remat)
from test_torch_numerics import use_reference_dot_order

from repro.models import ssm as JS
from repro_torch.models import ssm as S
from repro_torch.models.hybrid import split_counts
from repro_torch.models.transformer import layer_slice
from repro_torch.train.steps import _leaf_paths
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def hybrid_pair():
    return pair(ARCH)


def test_mamba2_block_quartet_backward_matches_reference(hybrid_pair, monkeypatch):
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp = hybrid_pair
    cfg = tm.cfg
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[1], jp["mamba_layers"])

    def jblock(p, xx):
        return JS.mamba2_block(p, xx, None, jnp.uint32(78), jm.cfg, None, None, "quartet")[0]

    jy, jgp, jgx = ref_block_vjp(jblock, jlayer, x, dy)
    layer = layer_slice(tp["mamba_layers"], 1)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(layer)]
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = S.mamba2_block(tree_unflatten(layer, leaves), xt, None, 78, cfg, None, "quartet")
    grads = torch.autograd.grad(y, [xt, *leaves], torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())
    grads_close(layer, grads[1:], jgp, flipped_columns=1)
    by_path = dict(zip(_leaf_paths(layer), grads[1:]))
    for name in (("dt_bias",), ("gate_norm", "scale"), ("A_log",), ("D",)):
        assert float(by_path[name].abs().max()) > 0, name


def test_model_gradients_with_the_shared_block_applied_twice(hybrid_pair):
    jm, jp, tm, tp = hybrid_pair
    assert split_counts(tm.cfg) == (2, 2, 1)  # two applications, a 1-layer tail
    tokens, labels = tokens_labels(2, 16, seed=8)
    jloss, jgrads = ref_loss_grads(jm, jp, jnp.asarray(tokens), jnp.asarray(labels), seed=5)
    loss, grads = port_loss_grads(tm, tp, tokens, labels, seed=5)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    grads_close(tp, grads, jgrads)
    shared = [g for p, g in zip(_leaf_paths(tp), grads) if p[0] == "shared_attn"]
    assert len(shared) == 9 and all(float(g.abs().max()) > 0 for g in shared)


def test_remat_on_and_off_give_the_same_gradients(hybrid_pair):
    _, _, tm, tp = hybrid_pair
    tokens, labels = tokens_labels(2, 16, seed=9)
    runs = [port_loss_grads(with_remat(tm, r), tp, tokens, labels, method="quartet", seed=3)
            for r in (True, False)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
