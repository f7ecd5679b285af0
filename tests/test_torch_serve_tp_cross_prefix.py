"""Tensor-parallel serving of the port's cross families on the CPU: reduced
whisper-tiny on the state pool, two gloo ranks against one device; the
twin of ``tests/test_torch_serve_tp_cross.py`` with the prefix cache.

At TP 2 the self-KV and cross-KV planes hold each rank's head block; the
cross-KV is encoded once at admission and each rank keeps its heads of it
(``steps.encode_cross``); decode reads both planes and all-gathers the
attention outputs.  With the prefix cache (cross-KV sharing: a warm
request aliases the encoded pages), the tokens equal TP 1's bit for bit
and each rank's planes equal the TP 1 planes' head slices.
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

CASES = [("whisper-tiny", None, True)]


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
def test_tp2_cross_token_exact(sweep, case):
    assert sweep[0][case]["eng"].backend == "statepool"
    R.assert_tokens_equal(sweep, case)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_planes_are_the_head_slices(sweep, case):
    R.assert_pools_are_head_slices(sweep, case)
