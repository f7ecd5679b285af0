"""Tensor- and expert-parallel serving of the port's MoE family on the CPU:
reduced qwen3-moe-235b-a22b on two gloo ranks against one device, paged
backend (the gather backend in ``tests/test_torch_serve_tp_moe_gather.py``).

The reference's sweep for its MoE member, without and with
self-speculation (k 2, paged backend only) and the prefix cache.  At TP 2
each rank attends over its KV head and runs its 4 of the 8 experts (the
expert seeds offset by its first expert), all-gathering both; the tokens
equal TP 1's bit for bit and each rank's pool equals the TP 1 pool's head
slice.
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

CASES = [("qwen3-moe-235b-a22b", "paged", False), ("qwen3-moe-235b-a22b", "paged", True)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    return R.sweep(tmp_path_factory, CASES)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_moe_token_exact(sweep, case):
    assert sweep[0][case]["eng"].model.cfg.num_experts % 2 == 0
    R.assert_tokens_equal(sweep, case)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_moe_pool_is_the_head_slice(sweep, case):
    R.assert_pools_are_head_slices(sweep, case)
