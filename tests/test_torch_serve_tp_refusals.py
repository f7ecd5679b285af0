"""The port's tensor-parallel engine refuses what the reference's refuses,
and never serves on one device silently: ``dp > 1`` through ``Engine``;
TP on the SSM and hybrid families and on dense slots (no head axis to
shard); TP 2 in a process that is no world of two; and a rank that fails
makes the others fail at the group's timeout rather than hang.
"""

import pytest
import torch

import _tp_ranks as R
from repro_torch.serve import Engine, EngineConfig, Placement, ShardingConfig

pytestmark = pytest.mark.sharded

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engine_refuses_like_the_reference():
    """These raise before any group is formed."""
    cfg, model, params = R.setup(ARCH)
    with pytest.raises(ValueError, match="ReplicatedEngine"):
        Engine(model, params, EngineConfig(sharding=ShardingConfig(tp=1, dp=2)))
    for arch, backend in (("falcon-mamba-7b", None), ("zamba2-7b", None),
                          ("whisper-tiny", "dense_slots")):
        _, m, p = R.setup(arch)
        with pytest.raises(ValueError, match="paged family"):
            Engine(m, p, EngineConfig(decode_backend=backend, sharding=ShardingConfig(tp=2)))


def test_tp_engine_without_a_group_raises():
    """No silent one-device run: TP 2 in a process that is no world of two."""
    _, model, params = R.setup(ARCH)
    with pytest.raises(ValueError, match="needs 2 devices"):
        Engine(model, params, EngineConfig(sharding=ShardingConfig(tp=2)))
    with pytest.raises(ValueError, match="needs 2 devices"):
        Placement(tp=2)


def test_a_failing_rank_fails_the_engine(tmp_path):
    """Rank 1 raises before its first step; rank 0, waiting in the tick's
    clock broadcast, fails at the group's timeout and exits non-zero."""
    ranks = R.start(tmp_path, 2, "failing_rank", ARCH, gloo_timeout_s=3, limit_s=60)
    with pytest.raises(RuntimeError) as err:
        ranks.join()
    msg = str(err.value)
    assert "rank 1 fails on purpose" in msg and "rank 0 exited 1" in msg
