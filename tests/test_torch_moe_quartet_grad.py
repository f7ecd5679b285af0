"""PyTorch port vs the JAX reference: a MoE layer's gradients under Quartet.

One ``moe_ffn`` forward and backward with ``method="quartet"`` on reduced
qwen3-moe (f32, 8 experts top-2, 2 × 64 tokens in one group, so each
expert takes a capacity of 64 rows), at a layer seed below and one above
2^31 (the experts' seeds fold in uint32): the reference's ``moe_ffn`` under
``jax.grad`` (plain path) against the port's, from the same weights, with
the reference's CPU dot order patched into the port's Hadamard
(``use_reference_dot_order``; every expert operand has 64 rows or more,
ROADMAP C4), so the stochastic-rounding operands of the expert linears
carry the reference's bits.  The routing, the dispatch, the Quartet
expert linears' Algorithm-1 backward, the combine and the router's
gradient all sit on the path; y, aux and the gradients of
⟨y, r⟩ + 0.3·aux with respect to x, the router and the gate/up/down stacks
are held to rtol 1e-4 (atol 1e-4·max|ref| for the gradients), as the
dense model's gradients are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import use_reference_dot_order

from repro.configs import get_reduced_config as jget_reduced
from repro.models import moe as JM
from repro_torch.configs import get_reduced_config
from repro_torch.convert import _leaf
from repro_torch.models import moe as TM
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(np_tree):
    if isinstance(np_tree, dict):
        return {k: _tree(v) for k, v in np_tree.items()}
    return _leaf(np_tree, "cpu")


def _close(got, want, rtol, atol_frac, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("seed", [9, 2**31 + 1])
def test_moe_ffn_quartet_grads_match_reference(seed, monkeypatch):
    use_reference_dot_order(monkeypatch)
    jcfg = jget_reduced(ARCH, dtype="float32")
    tcfg = get_reduced_config(ARCH, dtype="float32")
    assert TM.moe_capacity(tcfg, 128) == 64  # 64 rows an expert operand
    jp = JM.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jnp.uint32(seed), jcfg, method="quartet")
        return jnp.sum(y * r) + 0.3 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, x)
    tp = _tree(jax.device_get(jp))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_ffn(tree_unflatten(tp, leaves), xt, seed, tcfg, method="quartet")
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + 0.3 * aux, [xt, *leaves])
    _close(y.detach().numpy(), jy, 1e-4, 1e-5, "y")
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-4 * abs(float(jaux))
    _close(grads[0].numpy(), jgx, 1e-4, 1e-4, "dx")
    jleaves = jax.tree.leaves(jgp)
    assert len(jleaves) == len(leaves) == 4  # down, gate, router.w, up
    for name, g, jg in zip(("down", "gate", "router", "up"), grads[1:], jleaves):
        assert float(np.abs(np.asarray(jg)).max()) > 0
        _close(g.numpy(), jg, 1e-4, 1e-4, name)
