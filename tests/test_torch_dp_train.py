"""One Quartet train step of the reduced Llama, FSDP data-parallel over two
gloo ranks (microbatch 2, a ragged ``loss_mask``), against the port's
one-device step on the same weights and rows; and a rank's rows against
the reference's microbatch layout.  (``test_torch_dp_train_reference.py``
holds the same step against the reference's ``make_train_step``.)

Tolerances: each rank's loss divides by the global token count, so every
token's gradient is one device's bit for bit and the stochastic roundings
draw one device's bits (the counter window); what differs is where dW's
sum over tokens is split (two f32 partial sums, then their sum), so the
loss agrees within rtol 1e-6, the grad-norm within 1e-5 and each gradient
within 1e-5 relative L2 (measured: the loss equal, 8e-8 and 1.6e-7).
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


def ragged_batch() -> dict:
    """A global batch of 8 x 16 with a ragged loss mask (rows keep 16, 11,
    5, ... tokens)."""
    batch = TD.TokenBatcher(TD.SyntheticC4Dataset(D.VOCAB, seed=0), D.BATCH, D.SEQ).batch(0)
    keep = np.array([16, 11, 5, 16, 1, 9, 13, 7])[:, None]
    batch["loss_mask"] = (np.arange(D.SEQ)[None, :] < keep).astype(np.float32)
    return batch


def test_rank_rows_follow_the_reference_microbatch_layout():
    """Microbatch i is rows [i·G/m, (i+1)·G/m) of the global batch; rank r
    holds block r of each: rows i·G/m + r·G/(m·n) + j, not TokenBatcher's
    host block [r·G/n, ...)."""
    assert TD.rank_rows(8, 2, 0, 2) == [0, 1, 4, 5]
    assert TD.rank_rows(8, 2, 1, 2) == [2, 3, 6, 7]
    assert TD.rank_rows(32, 2, 3, 4) == [12, 13, 14, 15, 28, 29, 30, 31]
    b = TD.TokenBatcher(TD.SyntheticC4Dataset(D.VOCAB, seed=0), 8, D.SEQ)
    whole = b.batch(3)
    for r in range(2):
        mine = b.rank_batch(3, r, 2, microbatch=2)
        np.testing.assert_array_equal(mine["tokens"], whole["tokens"][TD.rank_rows(8, 2, r, 2)])
        # microbatch i of this rank = its block of the global microbatch i
        for i in range(2):
            np.testing.assert_array_equal(mine["labels"][2 * i:2 * i + 2],
                                          whole["labels"][4 * i + 2 * r:4 * i + 2 * r + 2])
    assert TD.rank_rows(8, 1, 0, 1) == list(range(8))
    with pytest.raises(ValueError, match="does not split"):
        TD.rank_rows(8, 3, 0, 2)


def test_dp2_step_equals_one_device(tmp_path):
    params = init_params(D.tiny_cfg(), torch.Generator().manual_seed(0), "cpu")
    batch = ragged_batch()
    ranks = D.start(tmp_path, 2, "dp_steps", params, batch, [{}])
    loss1, gn1, g1, _, n1 = D.step_grads(params, batch)
    res = ranks.join()
    (loss0, gn0, s0, dims, n0), = res[0]
    (_, gn_1, s1, _, _), = res[1]
    g2 = D.unshard([s0, s1], dims)
    # the sharding rules put K of column-parallel, N of row-parallel weights
    # and D of the embedding and head over data; the norms stay whole
    assert dims["layers/attn/wq/w"] == 1 and dims["layers/mlp/down/w"] == 2
    assert dims["embed/table"] == 1 and dims["lm_head/w"] == 0
    assert dims["final_norm/scale"] is None and dims["layers/attn_norm/scale"] is None
    assert gn0 == gn_1  # every rank reports the global norm
    assert n0 == n1  # a rank launches what one device does, microbatch for microbatch
    np.testing.assert_allclose(loss0, loss1, rtol=1e-6)
    np.testing.assert_allclose(gn0, gn1, rtol=1e-5)
    assert set(g2) == set(g1)
    for p in g1:
        assert g2[p].shape == g1[p].shape, p
        assert _rel_l2(g2[p], g1[p]) < 1e-5, (p, _rel_l2(g2[p], g1[p]))
