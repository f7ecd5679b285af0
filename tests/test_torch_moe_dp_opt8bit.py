"""The 8-bit AdamW on shards, and its checkpoints across data-parallel
widths (no JAX).

* On two gloo ranks, two updates of leaves split every way a shard can
  meet the blocks of 256 along the last axis (a leading dim; whole blocks;
  a block count the ranks do not divide, moments kept whole; halves that
  straddle a block; replicated): each rank's update equals the slice of the
  one-device update bit for bit, and its moments the slice (or the whole)
  of the one-device moments bit for bit; ``partition_state`` of the shards
  gives ``opt_partition``'s specs of the whole state.
* ``train.loop.train`` of the reduced qwen3-moe with the 8-bit AdamW and a
  bf16 master at dp 2, a checkpoint every step: the checkpoint restores at
  dp 1 to the ranks' gathered state bit for bit (parameters, int8 codes,
  scales, step), and a dp-1 run resumes from it to the one-device step from
  the restored state, bit for bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import _moe_dp_ranks as M
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import init_params
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.distributed import sharding as SH
from repro_torch.models import build_model
from repro_torch.optim import adamw8bit, cosine_warmup
from repro_torch.train.loop import train
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import make_train_step

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Sizes:
    shape = {"data": 2, "model": 1}
    axis_names = ("data", "model")


def test_sharded_8bit_update_is_the_whole_updates_slice(tmp_path):
    params, grads = M.opt8_inputs()
    ranks = M.start(tmp_path, 2, "opt8_ranks", params, grads)
    whole = M.opt8_updates(params, grads)
    res = ranks.join()
    for rank, r in enumerate(res):
        for step, (got, want) in enumerate(zip(r["steps"], whole)):
            assert set(got) == set(want)
            for path, w in want.items():
                kind, name = path.split("/")[0], path.split("/")[1]
                (shape, spec) = M.OPT8_LEAVES[name]
                g = got[path]
                if g.shape != w.shape:  # this rank's slice of the whole
                    dim = [i for i, e in enumerate(spec) if e][0]
                    if kind != "u" and dim == len(shape) - 1:
                        dim = g.ndim - (2 if path.endswith("/q") else 1)  # the block dim
                    m = g.shape[dim]
                    w = np.take(w, np.arange(rank * m, (rank + 1) * m), axis=dim)
                np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} step {step} {path}")
        # the moments' specs of the shards = opt_partition's of the whole state
        whole_state = adamw8bit(1e-2).init(M.D.to_torch(params))
        specs = {k: SH.P(*spec) for k, (_, spec) in M.OPT8_LEAVES.items()}
        want_specs = SH.opt_partition(whole_state, specs, _Sizes())["mu"]
        assert r["specs"] == {k: (tuple(v["q"]), tuple(v["s"])) for k, v in want_specs.items()}
    assert res[0]["specs"]["kept"] == ((None, None, None), (None, None))
    assert res[0]["specs"]["straddle"] == ((None, "data", None), (None, "data"))


def test_8bit_checkpoint_at_dp2_resumes_at_dp1(tmp_path):
    whole_dir = str(tmp_path / "ckpt")
    ranks = M.start(tmp_path, 2, "checkpoint_8bit", whole_dir)
    cfg = M.moe_cfg()
    model = build_model(cfg)
    opt = adamw8bit(cosine_warmup(1e-3, 10))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = make_train_state(params, opt, "bfloat16")
    res = ranks.join()
    assert res[0]["loss"] == res[1]["loss"] and res[0]["step"] == 2
    restored, meta = Checkpointer(whole_dir).restore(like)
    assert meta["step"] == 2 and restored.step == 2 and restored.opt_state["step"] == 2
    got = M._state_paths(restored)
    assert set(got) == set(res[0]["whole"])
    for p, w in res[0]["whole"].items():
        assert got[p].dtype == w.dtype, p
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    # a dp-1 run resumes from the dp-2 checkpoint: its step 2 is the
    # one-device step from the restored state
    resume_dir = str(tmp_path / "resume")
    shutil.copytree(os.path.join(whole_dir, "step_000000002"),
                    os.path.join(resume_dir, "step_000000002"))
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=0), 4, M.SEQ)
    state, hist = train(model, opt, batcher, 3, master_dtype="bfloat16", device="cpu",
                        params=params, checkpoint_dir=resume_dir, log_every=0)
    assert [h["step"] for h in hist] == [2]
    want, _ = make_train_step(model, opt)(
        restored, {k: torch.from_numpy(v) for k, v in batcher.batch(2).items()})
    got, want = M._state_paths(state), M._state_paths(want)
    for p, w in want.items():
        np.testing.assert_array_equal(got[p], w, err_msg=p)
