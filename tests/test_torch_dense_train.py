"""Reduced starcoder2-3b (the GELU MLP with biases) trained one Quartet
step on the plain path by the reference and by the port, from one
reference init (``tests/test_torch_dense_configs.py`` holds its logits).

Tolerance: loss, grad-norm, nll and every parameter within rtol 1e-4,
atol 1e-4·max|ref| per leaf, as ``tests/test_torch_train.py`` holds the
Llama steps (the backward's norms, attention and GELU round per library;
the stochastic-rounding operands carry the reference's bits under
``use_reference_dot_order``).  Its own file: the reference's jitted train
step takes most of its time to compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_configs import starcoder_pair_of
from test_torch_numerics import use_reference_dot_order

from repro.data import pipeline as JD
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


def test_starcoder2_train_step_matches_reference(monkeypatch):
    """One AdamW step (cosine warmup, clip 1.0) under Quartet on the plain
    path, from the same init on the same batch."""
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp = starcoder_pair_of()
    b = JD.TokenBatcher(JD.SyntheticC4Dataset(512, seed=0), 4, 16).batch(0)
    jopt = jadamw(jcosine(1e-3, 10))
    jstate, jm_ = jax.jit(jmake_train_step(jm, jopt))(
        jmake_train_state(jp, jopt), {k: jnp.asarray(v) for k, v in b.items()})
    opt = adamw(cosine_warmup(1e-3, 10))
    state, m = make_train_step(tm, opt)(make_train_state(tp, opt),
                                        {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "grad_norm", "nll"):
        _close(float(m[key]), float(jm_[key]), 1e-4, 0.0)
    for p, jp_ in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        _close(p.numpy(), jp_, 1e-4, 1e-4)
