"""Tensor-parallel serving of the port on the CPU: reduced qwen3-1.7b on
two gloo ranks against one device, paged backend.

Twin of the reference's ``tests/test_serve_sharded.py`` TP sweep, one case
a file (``tests/test_torch_serve_tp_*.py``: self-speculation with the
prefix cache, the gather backend, the MoE family, the cross families;
the refusals in ``tests/test_torch_serve_tp_refusals.py``).  TP 2 gives
tokens equal to TP 1 bit for bit; each rank's pool after the drain equals
the TP 1 pool's head slice (``Placement.shard_pool``) and the pool's bytes
are the whole pool's; the pool health sampled every tick equals TP 1's
exactly; the ranks' weights are the first rank's (the other rank starts
from other values).

The ranks run in processes of their own (``tests/_tp_ranks.py``) while
this process serves TP 1.
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

CASES = [("qwen3-1.7b", "paged", False)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    return R.sweep(tmp_path_factory, CASES, health_case=CASES[0])


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_token_exact(sweep, case):
    R.assert_tokens_equal(sweep, case)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_pool_is_the_head_slice(sweep, case):
    R.assert_pools_are_head_slices(sweep, case)


def test_tp2_pool_health_equals_one_device(sweep):
    """Every tick's sample sums the ranks' int64 counts over the group, so
    the gauges and the scale histograms equal TP 1's exactly."""
    base, ranks = sweep
    want = base[CASES[0]]["health"]
    assert want["samples"] > 0 and want["kv_clip_fraction_k"] is not None
    for r in ranks:
        assert r[CASES[0]]["health"] == want
