"""Tensor-parallel serving of the port on the CPU: reduced qwen3-1.7b on
two gloo ranks against one device, paged backend, self-speculation (k 2)
and the prefix cache together, the allocator audited and the ranks'
schedules compared every tick: tokens equal TP 1's bit for bit, each
rank's pool equals the TP 1 pool's head slice.  The plain run:
``tests/test_torch_serve_tp.py``.
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

CASES = [("qwen3-1.7b", "paged", True)]


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
def test_tp2_token_exact(sweep, case):
    R.assert_tokens_equal(sweep, case)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_pool_is_the_head_slice(sweep, case):
    R.assert_pools_are_head_slices(sweep, case)
