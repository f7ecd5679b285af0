"""A MoE layer (``moe_ffn``) at data-parallel width 2 against the
reference's one-device ``moe_ffn`` under ``jax.grad``.

Two gloo ranks each hold 2 of the 4 rows of x [4, 32, 128] (64 tokens a
rank) under a two-rank plan, in both layouts of
``distributed.context.moe_group_layout``: one group of 128 tokens shared
by the two ranks (the default ``group_tokens``; each rank runs 4 of the 8
experts over the group's 64 slots) and whole groups on each rank
(``group_tokens=64``: each rank routes its own group, an expert's 32 slots
a rank in a window of 64).  Reduced qwen3-moe (f32, 8 experts top-2) under
the bf16 method and under Quartet, and reduced arctic (its dense residual
MLP on the rank's token window) under Quartet.  The ranks and this process
rotate in the reference's CPU summation order (``use_reference_dot_order``;
every expert operand of the reference has 64 rows or more, ROADMAP C4).

Held: each rank's ``sel_idx`` equals the reference's at its groups bit for
bit and ``sel_gate`` within rtol 2e-6 (the reference's softmax rounds
otherwise, as ``tests/test_torch_moe.py`` holds it); the ranks' y rows
within rtol 1e-4, atol 1e-5·max|ref|; their aux shares summed within rtol
1e-5; the gradients of ⟨y, r⟩ + 0.3·aux (x's rows concatenated, every
parameter's summed over the ranks) within rtol 1e-4, atol 1e-4·max|ref|, as
``tests/test_torch_moe_quartet_grad.py`` holds one device's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_numerics import use_reference_dot_order

import _moe_dp_ranks as M
from repro.configs import get_reduced_config as jget_reduced
from repro.models import moe as JM

pytestmark = pytest.mark.sharded

SEED = 2**31 + 7  # the experts' seeds fold in uint32
CASES = [("qwen3-moe-235b-a22b", "bf16", 4096), ("qwen3-moe-235b-a22b", "quartet", 4096),
         ("qwen3-moe-235b-a22b", "bf16", 64), ("qwen3-moe-235b-a22b", "quartet", 64),
         ("arctic-480b", "quartet", 4096)]


def _weights(arch):
    jcfg = jget_reduced(arch, dtype="float32")
    return jcfg, jax.device_get(JM.init_moe_ffn(jax.random.PRNGKey(1), jcfg, jnp.float32))


def _inputs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, M.SEQ, 128)).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results for every case, started once for the module."""
    x, r = _inputs()
    cases = [dict(params=_weights(arch)[1], x=x, r=r, seed=SEED, method=method,
                  group_tokens=gt, arch=arch, ref_order=True) for arch, method, gt in CASES]
    started = M.start(tmp_path_factory.mktemp("moe_dp_ffn"), 2, "ffn_ranks", cases)
    done = {}

    def result(i):
        if not done:
            done["res"] = started.join()
        return [rk[i] for rk in done["res"]]

    return result


def _close(got, want, rtol, atol_frac, name):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{a}-{m}-g{g}" for a, m, g in CASES])
def test_moe_ffn_dp2_equals_the_reference(ranks, case, monkeypatch):
    arch, method, group_tokens = CASES[case]
    use_reference_dot_order(monkeypatch)
    jcfg, jp = _weights(arch)
    x, r = _inputs()
    top_k = jax.lax.top_k

    def loss(p, xx):
        calls = []

        def rec(v, k):
            out = top_k(v, k)
            calls.append(out)
            return out

        jax.lax.top_k = rec
        try:
            y, aux = JM.moe_ffn(p, xx, jnp.uint32(SEED), jcfg, method=method,
                                group_tokens=group_tokens)
        finally:
            jax.lax.top_k = top_k
        return jnp.sum(y * r) + 0.3 * aux, (y, aux, calls[1])

    (_, (jy, jaux, (sel_val, sel_idx))), (jgp, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jp, x)
    sel_val, sel_idx = np.asarray(sel_val), np.asarray(sel_idx)
    res = ranks(case)
    for rank, (_, _, _, (first, t_idx, t_gate)) in enumerate(res):
        groups = slice(first, first + t_idx.shape[0])
        np.testing.assert_array_equal(t_idx, sel_idx[groups], err_msg=f"rank {rank} sel_idx")
        np.testing.assert_allclose(t_gate, np.where(sel_val > 0, sel_val, 0.0)[groups],
                                   rtol=2e-6, atol=0, err_msg=f"rank {rank} sel_gate")
    # the two layouts: one shared group, or a group a rank
    assert [rk[3][0] for rk in res] == ([0, 0] if group_tokens == 4096 else [0, 1])
    _close(np.concatenate([rk[0] for rk in res]), np.asarray(jy), 1e-4, 1e-5, "y")
    aux = sum(rk[1] for rk in res)
    assert abs(aux - float(jaux)) <= 1e-5 * abs(float(jaux)), (aux, float(jaux))
    _close(np.concatenate([rk[2][0] for rk in res]), np.asarray(jgx), 1e-4, 1e-4, "dx")
    jleaves = jax.tree.leaves(jgp)
    assert len(jleaves) == len(res[0][2]) - 1
    for i, jg in enumerate(jleaves, 1):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        _close(res[0][2][i] + res[1][2][i], jg, 1e-4, 1e-4, f"parameter leaf {i}")
