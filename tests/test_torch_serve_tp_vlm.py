"""Tensor-parallel serving of the port's VLM on the CPU: reduced
llama-3.2-vision-11b (its gates set, the bf16 method) on the state pool,
two gloo ranks against one device; the twin of
``tests/test_torch_serve_tp_cross.py``.

At TP 2 the self-KV and cross-KV planes hold each rank's head block; the
cross-KV is encoded once at admission and each rank keeps its heads of it
(``steps.encode_cross``); decode reads both planes and all-gathers the
attention outputs.  Without and with the prefix cache (cross-KV sharing),
the tokens equal TP 1's bit for bit and each rank's planes equal the TP 1
planes' head slices.  A plane whose head count tp does not divide (the
published whisper-tiny's 6 heads at tp 4) is replicated, as the reference's
``_fit`` leaves it (``tests/test_torch_serve_tp_cross.py``).
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

CASES = [("llama-3.2-vision-11b", None, False), ("llama-3.2-vision-11b", None, True)]
# the linears run whole on every rank, so the method does not reach what
# tensor parallelism changes; the plain bf16 products keep the file short
# (the Quartet method's TP runs are the qwen3, MoE and whisper files')
METHOD = "bf16"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    return R.sweep(tmp_path_factory, CASES, METHOD)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_cross_token_exact(sweep, case):
    assert sweep[0][case]["eng"].backend == "statepool"
    R.assert_tokens_equal(sweep, case)


@pytest.mark.parametrize("case", CASES, ids=R.case_id)
def test_tp2_planes_are_the_head_slices(sweep, case):
    R.assert_pools_are_head_slices(sweep, case)
