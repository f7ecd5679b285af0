"""A reduced Llama's data-parallel step over two gloo ranks with
``QuartetConfig.fp4_allgather`` on against off, bf16 compute (the card's
dtype), and against the one-device step.

On and off compute the same forward (loss bit for bit) and the same
gradient up to where the f32 sum across ranks falls (off sums dW, on sums
dW_rot before the mask and H⁻¹): within 1e-4 relative L2 a leaf.  Against
the one-device step: the loss bit for bit, the grad-norm within 1e-4,
every gradient within 1e-4 relative L2 (measured 1.3e-5: the clip's
scale) but the embedding's, within 1e-2 (measured 2.7e-3): on the CPU one
device sums a token's embedding gradients in bf16, where the ranks sum
theirs in f32.
"""

import numpy as np
import pytest
import torch

import _dp_ranks as D
from repro_torch.convert import init_params
from repro_torch.data import pipeline as TD

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_dp2_fp4_allgather_on_equals_off(tmp_path):
    params = init_params(D.tiny_cfg(), torch.Generator().manual_seed(3), "cpu")
    batch = TD.TokenBatcher(TD.SyntheticC4Dataset(D.VOCAB, seed=1), D.BATCH, D.SEQ).batch(0)
    runs = [{"dtype": "bfloat16"}, {"dtype": "bfloat16", "fp4": True}]
    ranks = D.start(tmp_path, 2, "dp_steps", params, batch, runs)
    one = D.step_grads(params, batch, dtype="bfloat16")
    res = ranks.join()
    off, on = ([res[r][i] for r in range(2)] for i in range(2))
    assert off[0][0] == on[0][0] == one[0]  # the loss: the same forward
    np.testing.assert_allclose(on[0][1], off[0][1], rtol=1e-6)
    np.testing.assert_allclose(off[0][1], one[1], rtol=1e-4)
    g_off = D.unshard([o[2] for o in off], off[0][3])
    g_on = D.unshard([o[2] for o in on], on[0][3])
    for p in one[2]:
        assert _rel_l2(g_on[p], g_off[p]) < 1e-4, (p, _rel_l2(g_on[p], g_off[p]))
        tol = 1e-2 if p == "embed/table" else 1e-4
        assert _rel_l2(g_off[p], one[2][p]) < tol, (p, _rel_l2(g_off[p], one[2][p]))
    # B1 / B3 launches a rank equal: the gather moves codes, not an extra quantize
    assert on[0][4] == off[0][4]
