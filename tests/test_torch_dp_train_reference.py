"""The reduced Llama's Quartet train step, FSDP data-parallel over two
gloo ranks (microbatch 2, the ragged ``loss_mask`` of
``test_torch_dp_train.py``), against the reference's ``make_train_step``
from the same converted weights.

Tolerance: loss and grad-norm within rtol 1e-4, every gradient within
rtol 1e-4, atol 1e-4·max|ref| a leaf, as ``tests/test_torch_train.py``
holds the one-device steps (the ranks and this process rotate in the
reference's CPU summation order, ``use_reference_dot_order``, so the
stochastic-rounding operands carry the reference's bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dp_train import ragged_batch

import _dp_ranks as D
from repro.configs import llama_paper as JLP
from repro.models import build_model as jbuild
from repro.optim.adamw import Optimizer as JOptimizer
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.convert import params_from_jax

pytestmark = pytest.mark.sharded


def _from_jax(tree):
    if isinstance(tree, dict):
        return {k: _from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_dp2_step_equals_the_reference(tmp_path):
    jcfg = dataclasses.replace(JLP.tiny_llama(d=128, layers=2, vocab=D.VOCAB), dtype="float32")
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = ragged_batch()
    ranks = D.start(tmp_path, 2, "dp_steps",
                    params_from_jax(jax.device_get(jp), D.tiny_cfg(), "cpu"), batch, [{}], True)
    # the reference's step, with an optimizer that keeps its gradients
    opt = JOptimizer(lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
                     lambda g, s, p: (jax.tree.map(jnp.zeros_like, g), {"g": g}))
    state, m = jax.jit(jmake_train_step(jm, opt, microbatch=D.MICRO))(
        jmake_train_state(jp, opt), {k: jnp.asarray(v) for k, v in batch.items()})
    res = ranks.join()
    (loss, gn, s0, dims, _), = res[0]
    (_, _, s1, _, _), = res[1]
    got = D.unshard([s0, s1], dims)
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(gn, float(m["grad_norm"]), rtol=1e-4)
    want = D.paths(_from_jax(state.opt_state["g"]))
    assert set(want) == set(got)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=p)
