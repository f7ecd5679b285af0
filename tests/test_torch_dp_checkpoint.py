"""Data-parallel checkpoints: a run at dp 2 writes whole leaves (the
reference's layout); restored at dp 2 it gives each rank its shards back
bit for bit, and at dp 1 the whole state bit for bit; a dp-2 run killed
after step 1's checkpoint and started again ends bit for bit where the
unbroken run ends."""

import numpy as np
import pytest
import torch

import _dp_ranks as D
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import init_params
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.state import make_train_state

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dp2_checkpoints_restore_at_dp1_and_dp2_and_resume(tmp_path):
    ranks = D.start(tmp_path, 2, "dp_checkpoint", str(tmp_path / "whole"),
                    str(tmp_path / "part"))
    res = ranks.join()
    for r in res:
        assert r["restored_equal"] and r["resumed_equal"], r
        assert r["steps"] == [0, 1] and r["resumed_steps"] == [1]
    assert res[0]["loss"] == res[1]["loss"]
    # dp 1: the whole state from the same files, leaf for leaf
    cfg = D.tiny_cfg()
    opt = adamw(cosine_warmup(1e-3, 10))
    like = make_train_state(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), opt)
    state, meta = Checkpointer(str(tmp_path / "whole")).restore(like)
    assert meta["step"] == 2 and state.step == 2 and state.opt_state["step"] == 2
    whole = res[0]["whole"]
    got = D.paths(state.params)
    assert set(got) == set(whole)
    for p in whole:
        np.testing.assert_array_equal(got[p], whole[p])
    for p, v in D.paths(state.opt_state["mu"]).items():
        np.testing.assert_array_equal(v, res[0]["whole_mu"][p])
