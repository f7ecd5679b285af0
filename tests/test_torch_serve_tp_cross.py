"""Tensor-parallel serving of the port's cross families on the CPU: reduced
whisper-tiny on the state pool, two gloo ranks against one device (the VLM
in ``tests/test_torch_serve_tp_vlm.py``).

At TP 2 the self-KV and cross-KV planes hold each rank's head block; the
cross-KV is encoded once at admission and each rank keeps its heads of it
(``steps.encode_cross``); decode reads both planes and all-gathers the
attention outputs: the tokens equal TP 1's bit for bit and each rank's
planes equal the TP 1 planes' head slices (with the prefix cache, cross-KV
sharing: ``tests/test_torch_serve_tp_cross_prefix.py``).  A plane whose head count tp does not divide (the
published whisper-tiny's 6 heads at tp 4) is replicated, as the reference's
``_fit`` leaves it.
"""

import pytest
import torch

import _tp_ranks as R
from repro_torch.serve.paged_cache import PagedCache

pytestmark = pytest.mark.sharded

CASES = [("whisper-tiny", None, False)]


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


def test_a_plane_tp_does_not_divide_is_replicated():
    """6 heads at tp 4 (whisper-tiny's published width): every rank holds
    all of them, no health reduction runs over the group, and the models'
    detection sees no slice."""
    p = R.one_rank_of_two(0)
    p.tp, p.mesh.shape = 4, {"model": 4}
    c = PagedCache(None, n_slots=1, pages_per_slot=2, page_size=8, device="cpu",
                   geometry=(4, 6, 64), dtype="bfloat16", placement=p)
    assert c.local_heads == 6 and c.pool["k_codes"].shape[3] == 6
    assert c.shard_group is None and c.cache_bytes() == c.rank_bytes()
    c8 = PagedCache(None, n_slots=1, pages_per_slot=2, page_size=8, device="cpu",
                    geometry=(4, 8, 64), dtype="bfloat16", placement=p)
    assert c8.local_heads == 2 and c8.cache_bytes() == 4 * c8.rank_bytes()
