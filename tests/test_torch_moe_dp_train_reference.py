"""The reduced qwen3-moe train step (f32, 2 layers, 8 experts top-2), FSDP
data-parallel over two gloo ranks, against the reference's one-device
``make_train_step`` from the same converted weights, with an optimizer that
keeps the step's gradients.

The global batch of 4 × 32 tokens is one microbatch: each rank holds 2 rows
(64 tokens) of the reference's one group of 128, so every MoE layer takes
the shared-group layout (``distributed.context.moe_group_layout``: the group
gathered and routed alike on both ranks, 4 of the 8 experts a rank over the
group's 64 slots).  The ranks rotate in the reference's CPU summation order
(``use_reference_dot_order``; every operand of the reference has 64 rows or
more, ROADMAP C4), so the stochastic-rounding operands carry its bits.

Held: each layer's capacity selection on each rank equals the reference
forward's (recorded through ``jax.debug.callback``) bit for bit; loss and
grad-norm within rtol 1e-4 and aux within rtol 1e-5 (the ranks' shares
summed); every gradient within rtol 1e-4, atol 1e-5·max a leaf of the
port's one-device step (this process, the same order patched in), and
under the bf16 method within rtol 1e-4, atol 1e-4·max|ref| of the
reference's, as ``tests/test_torch_dp_train_reference.py`` holds the dense
step.  Under Quartet the port's one-device step itself differs from the
reference's in 118 of the embedding's 65536 gradient elements (max 2.3e-4)
and 72 of the attention norm's: attention's backward rounds otherwise in
PyTorch than in XLA, and one stochastic rounding of the first layer's dy
falls the other way (ROADMAP C4), so its gradients are held against the
port's one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_numerics import use_reference_dot_order

import _dp_ranks as D
import _moe_dp_ranks as M
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.optim.adamw import Optimizer as JOptimizer
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the one-device port step in this process (the
    suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_selection(jm, jp, tokens, seed, method):
    """Each MoE layer's ``sel_idx`` in the reference's forward under
    ``method``, in layer order (its capacity ``top_k`` recorded as it
    runs)."""
    top_k, calls = jax.lax.top_k, []

    def rec(v, k):
        out = top_k(v, k)
        if v.shape[-1] != jm.cfg.num_experts:  # capacity selection, not the router's
            jax.debug.callback(lambda i: calls.append(np.asarray(i)), out[1])
        return out

    jax.lax.top_k = rec
    try:
        jax.block_until_ready(jax.jit(lambda p, t: jm.forward(
            p, t, jnp.uint32(seed), method=method, features_only=True)[0])(jp, tokens))
    finally:
        jax.lax.top_k = top_k
    return calls


def test_moe_dp2_quartet_step_equals_the_reference(tmp_path, monkeypatch):
    check_step(tmp_path, "quartet", monkeypatch)


def check_step(tmp_path, method, monkeypatch):
    """The module docstring's check under ``method``."""
    jcfg = jget_reduced(M.ARCH, dtype="float32")
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = TokenBatcher(SyntheticC4Dataset(jcfg.vocab_size, seed=3), 4, M.SEQ).batch(0)
    tp = params_from_jax(jax.device_get(jp), M.moe_cfg(), "cpu")
    ranks = M.start(tmp_path, 2, "moe_step_ranks", tp, batch, [{"method": method}], True)
    use_reference_dot_order(monkeypatch)
    one = M.moe_step(tp, batch, method=method)
    opt = JOptimizer(lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
                     lambda g, s, p: (jax.tree.map(jnp.zeros_like, g), {"g": g}))
    state, m = jax.jit(jmake_train_step(jm, opt, method=method))(
        jmake_train_state(jp, opt), {k: jnp.asarray(v) for k, v in batch.items()})
    want_sel = _reference_selection(jm, jp, jnp.asarray(batch["tokens"]), 1, method)
    res = ranks.join()
    for rank, ((*_, routing),) in enumerate(res):
        assert len(routing) == len(want_sel) == jcfg.num_layers
        for layer, ((first, sel), want) in enumerate(zip(routing.values(), want_sel)):
            np.testing.assert_array_equal(sel, want[first:first + sel.shape[0]],
                                          err_msg=f"rank {rank} layer {layer}")
    (loss, gn, aux, g0, dims, _, _), = res[0]
    (loss1, _, aux1, g1, _, _, _), = res[1]
    assert loss == loss1 and aux == aux1  # the metrics come back reduced
    np.testing.assert_allclose(loss[0], float(m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(gn[0], float(m["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(aux[0], float(m["aux"]), rtol=1e-5)
    got = D.unshard([g0, g1], dims)
    assert set(one[3]) == set(got)
    for p, w in one[3].items():
        np.testing.assert_allclose(got[p], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=p)
    if method == "bf16":
        want = D.paths(D.to_torch(jax.device_get(state.opt_state["g"])))
        assert set(want) == set(got)
        for p, w in want.items():
            np.testing.assert_allclose(got[p], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=p)
