"""Training the SSM family (Mamba1, reduced falcon-mamba-7b): the port's
gradients and train steps against the reference's on the CPU, from one
reference init carried over leaf by leaf (``params_from_jax``).

* The model's mean next-token loss and every leaf's gradient (the four
  projections, the causal conv, the selective scan's backward through its
  loop over time, ``A_log`` and ``D`` in f32, the tied embedding) against
  ``jax.grad`` of the reference's, f32, under ``bf16``: rtol 1e-4 and atol
  1e-4·max|ref| per leaf, the tolerance of ``test_torch_dense_train.py``.
* One ``mamba1_block`` forward and backward under Quartet against
  ``jax.vjp`` of the reference's plain path, with the reference's CPU dot
  order patched into the port's Hadamard (``use_reference_dot_order``) and
  256-row operands (ROADMAP C4), so the stochastic-rounding operands carry
  the reference's bits: output and gradients within rtol 1e-4 (atol
  1e-5·max|ref| for the output, 1e-4 for the gradients), as
  ``test_torch_moe_quartet_grad.py`` holds a MoE layer.
* Two ``make_train_step`` steps (``bf16``) from the reference's state
  (:func:`_family_train.train_steps_match` states their tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _family_train import (grads_close, one_thread, pair, port_loss_grads,  # noqa: F401
                           ref_block_vjp, ref_loss_grads, tokens_labels, train_steps_match)
from test_torch_numerics import use_reference_dot_order

from repro.models import ssm as JS
from repro_torch.models import ssm as S
from repro_torch.models.transformer import layer_slice
from repro_torch.train.steps import _leaf_paths
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def ssm_pair():
    return pair(ARCH)


def test_model_gradients_match_reference(ssm_pair):
    jm, jp, tm, tp = ssm_pair
    tokens, labels = tokens_labels(2, 24, seed=7)
    jloss, jgrads = ref_loss_grads(jm, jp, jnp.asarray(tokens), jnp.asarray(labels))
    loss, grads = port_loss_grads(tm, tp, tokens, labels)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    grads_close(tp, grads, jgrads)
    by_path = dict(zip(_leaf_paths(tp), grads))
    for name in ("A_log", "D", "conv_w", "conv_b"):  # the f32 leaves and the conv reach it
        g = by_path[("layers", name)]
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0, name
    assert by_path[("layers", "A_log")].dtype == torch.float32


def test_mamba1_block_quartet_backward_matches_reference(ssm_pair, monkeypatch):
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp = ssm_pair
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"])

    def jblock(p, xx):
        return JS.mamba1_block(p, xx, None, jnp.uint32(77), jm.cfg, None, None, "quartet")[0]

    jy, jgp, jgx = ref_block_vjp(jblock, jlayer, x, dy)
    layer = layer_slice(tp["layers"], 0)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(layer)]
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = S.mamba1_block(tree_unflatten(layer, leaves), xt, None, 77, cfg, None, "quartet")
    grads = torch.autograd.grad(y, [xt, *leaves], torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())
    grads_close(layer, grads[1:], jgp)


def test_two_train_steps_match_reference(ssm_pair):
    jm, jp, tm, tp = ssm_pair
    state, met = train_steps_match(jm, jp, tm, tp)
    assert np.isfinite(float(met["loss"])) and state.step == 2
